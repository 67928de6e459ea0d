"""Blender-format dynamic dataset loaders (host side, numpy).

The port's own copy of ``nvfi_tpu/data/blender.py:27-196``:

* ``load_blender_data``: one camera a frame, ``transforms_{train,val,test}.json``
  with a ``time`` a frame; RGBA composited onto white or black; an extra
  ``'init'`` split of the t == 0 train frames;
* ``load_blender_data_dynamic``: multi-camera rigs, a pose and its frames a
  camera;
* ``load_blender_data_segm`` / ``_nosegm``: one ``transforms.json`` of
  ``img_path`` (and ``segm_path`` .npy masks) entries.

PNGs are read by the port's own codec (``utils/png.py``), which gives the
uint8 values Pillow gives, so the loaders return the JAX package's arrays
bit for bit.  Half resolution is a 2x2 area mean.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.png import read_png


def _imread(path: str) -> np.ndarray:
    return read_png(path).astype(np.float32) / 255.0


def _composite(image: np.ndarray, white_background: bool) -> np.ndarray:
    if image.shape[-1] == 4:
        rgb, a = image[..., :3], image[..., 3:]
        if white_background:
            return rgb * a + (1.0 - a)
        return rgb * a
    return image


def _half_res(img: np.ndarray) -> np.ndarray:
    """2x area downsample (equivalent to cv2.INTER_AREA at exactly half size)."""
    H, W = img.shape[:2]
    h, w = H // 2, W // 2
    img = img[: h * 2, : w * 2]
    return img.reshape(h, 2, w, 2, -1).mean(axis=(1, 3))


def _spherical_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """Spiral render-pose fallback (reference load_blender.py:62-67)."""
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rp = np.eye(4, dtype=np.float32)
    c, s = np.cos(phi / 180.0 * np.pi), np.sin(phi / 180.0 * np.pi)
    rp[1, 1], rp[1, 2], rp[2, 1], rp[2, 2] = c, -s, s, c
    rt = np.eye(4, dtype=np.float32)
    c, s = np.cos(theta / 180.0 * np.pi), np.sin(theta / 180.0 * np.pi)
    rt[0, 0], rt[0, 2], rt[2, 0], rt[2, 2] = c, -s, s, c
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ rt @ rp @ trans


def load_blender_data(basedir, half_res=False, testskip=1, white_background=True):
    """Returns (all_imgs, all_poses, all_times, counts, render_poses,
    render_times, [H, W, focal]) with the reference's dict-of-splits layout."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, all_times, counts = {}, {}, {}, {}
    imgs_init, poses_init, times_init = [], [], []
    for s in splits:
        meta = metas[s]
        imgs, poses, times = [], [], []
        for frame in meta["frames"][:: max(testskip, 1)]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            image = _composite(_imread(fname), white_background)
            imgs.append(image)
            pose = np.asarray(frame["transform_matrix"], dtype=np.float32)
            poses.append(pose)
            cur_time = frame.get("time", 0)
            times.append(cur_time)
            if s == "train" and cur_time == 0.0:
                imgs_init.append(image)
                poses_init.append(pose)
                times_init.append(cur_time)
        counts[s] = len(imgs)
        all_imgs[s] = np.stack(imgs)
        all_poses[s] = poses
        all_times[s] = times

    counts["init"] = len(imgs_init)
    all_imgs["init"] = np.stack(imgs_init) if imgs_init else np.zeros((0,))
    all_poses["init"] = poses_init
    all_times["init"] = times_init

    H, W = all_imgs["train"][0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_path = os.path.join(basedir, "transforms_render.json")
    if os.path.exists(render_path):
        with open(render_path) as fp:
            meta = json.load(fp)
        render_poses = np.stack(
            [np.asarray(f["transform_matrix"], dtype=np.float32) for f in meta["frames"]]
        )
    else:
        render_poses = np.stack(
            [_spherical_pose(a, -30.0, 4.0) for a in np.linspace(-180, 180, 41)[:-1]]
        )
    render_times = np.linspace(0.0, 1.0, render_poses.shape[0], dtype=np.float32)

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        for split in all_imgs:
            if len(all_imgs[split]):
                all_imgs[split] = np.stack([_half_res(im) for im in all_imgs[split]])

    return all_imgs, all_poses, all_times, counts, render_poses, render_times, [int(H), int(W), focal]


def load_blender_data_dynamic(basedir, half_res=False, testskip=1, white_background=True):
    """Multi-camera layout: meta['data'][cam] has one pose + frames per camera
    (reference load_blender_dynamic.py:71-173)."""
    splits = ["train", "val", "test"]
    all_imgs, all_poses, all_times, counts = {}, {}, {}, {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            meta = json.load(fp)
        imgs, poses, times = [], [], []
        for cam in meta["data"]:
            pose = np.asarray(cam["transform_matrix"], dtype=np.float32)
            for frame in cam["frames"][:: max(testskip, 1)]:
                image = _composite(
                    _imread(os.path.join(basedir, frame["file_path"] + ".png")),
                    white_background,
                )
                imgs.append(image)
                poses.append(pose)
                times.append(frame.get("time", 0))
        counts[s] = len(imgs)
        all_imgs[s] = np.stack(imgs)
        all_poses[s] = poses
        all_times[s] = times
        camera_angle_x = float(meta["camera_angle_x"])

    H, W = all_imgs["train"][0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    if half_res:
        H, W = H // 2, W // 2
        focal /= 2.0
        for split in all_imgs:
            all_imgs[split] = np.stack([_half_res(im) for im in all_imgs[split]])
    return all_imgs, all_poses, all_times, counts, None, None, [int(H), int(W), focal]


def _load_flat(basedir, half_res, testskip, white_background, with_segm):
    with open(os.path.join(basedir, "transforms.json")) as fp:
        meta = json.load(fp)
    imgs, poses, times, segms = [], [], [], []
    for frame in meta["frames"][:: max(testskip, 1)]:
        image = _composite(
            _imread(os.path.join(basedir, frame["img_path"] + ".png")), white_background
        )
        imgs.append(image)
        poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))
        times.append(frame.get("time", 0))
        if with_segm:
            segms.append(np.load(os.path.join(basedir, frame["segm_path"] + ".npy")).astype(np.int32))
    imgs = np.stack(imgs)
    H, W = imgs[0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    if half_res:
        H, W = H // 2, W // 2
        focal /= 2.0
        imgs = np.stack([_half_res(im) for im in imgs])
    segms = np.stack(segms) if with_segm else None
    return imgs, poses, segms, times, [int(H), int(W), focal]


def load_blender_data_segm(basedir, half_res=False, testskip=1, white_background=True):
    imgs, poses, segms, times, hwf = _load_flat(basedir, half_res, testskip, white_background, True)
    return imgs, poses, segms, times, None, None, None, hwf


def load_blender_data_nosegm(basedir, half_res=False, testskip=1, white_background=True):
    imgs, poses, _, times, hwf = _load_flat(basedir, half_res, testskip, white_background, False)
    return imgs, poses, times, None, None, None, hwf
