"""The port's host-side data held against the JAX package on the CPU: the
synthetic scenes and their exact velocity, the four blender loaders on a
dataset that JAX's ``write_blender_dataset`` wrote, the port's own writer,
and the PNG codec (``nvfi_torch/utils/png.py``) against Pillow."""

import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nvfi_tpu.data import blender as jblender
from nvfi_tpu.data import synthetic as jsynthetic
from nvfi_torch.data import blender, synthetic
from nvfi_torch.utils import png

LOADERS = ("load_blender_data", "load_blender_data_dynamic", "load_blender_data_segm",
           "load_blender_data_nosegm")


def _assert_same(got, want, path="data"):
    """Equal bit for bit, dtype included, through dicts, lists and tuples."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, jsynthetic.RigidSphere):
        assert type(got).__name__ == "RigidSphere", path
        _assert_same(vars(got), vars(want), path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("objects,size", [("bat", 16), ("chessboard_slow", 20), ("fan", 24)])
def test_synthetic_scene_and_velocity_match_jax(objects, size):
    kw = dict(n_train=5, n_val=2, n_test=3, H=size, W=size, objects=objects,
              white_background=objects != "chessboard_slow")
    got, want = synthetic.make_synthetic_scene(**kw), jsynthetic.make_synthetic_scene(**kw)
    _assert_same(got, want)
    x = np.random.RandomState(3).uniform(-2, 2, (400, 3)).astype(np.float32)
    for t in (0.0, 0.4, 0.9):
        v = synthetic.scene_velocity(got[7]["objects"], x, t)
        np.testing.assert_array_equal(v, jsynthetic.scene_velocity(want[7]["objects"], x, t))
    assert np.abs(v).max() > 0.1  # some points lie in a mover


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A 4-camera chessboard_slow scene written by JAX's writer (Pillow), with
    a multi-camera copy of its splits for the dynamic loader."""
    root = tmp_path_factory.mktemp("blender")
    jsynthetic.write_blender_dataset(str(root), H=18, W=18, n_train=3, n_val=2, n_test=3,
                                     objects="chessboard_slow", white_background=False)
    for split in ("train", "val", "test"):
        with open(root / f"transforms_{split}.json") as f:
            meta = json.load(f)
        cams = {}
        for frame in meta["frames"]:
            key = json.dumps(frame["transform_matrix"])
            cams.setdefault(key, {"transform_matrix": frame["transform_matrix"], "frames": []})
            cams[key]["frames"].append({"file_path": frame["file_path"], "time": frame["time"]})
        with open(root / f"dynamic_{split}.json", "w") as f:
            json.dump({"camera_angle_x": meta["camera_angle_x"], "data": list(cams.values())}, f)
    dynamic = root / "dynamic"
    dynamic.mkdir()
    for split in ("train", "val", "test"):
        os.symlink(root / split, dynamic / split)
        shutil.copy(root / f"dynamic_{split}.json", dynamic / f"transforms_{split}.json")
    return root


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize("half_res", [False, True])
@pytest.mark.parametrize("white_background", [False, True])
def test_loaders_match_jax(written, loader, half_res, white_background):
    base = str(written / "dynamic") if loader == "load_blender_data_dynamic" else str(written)
    kw = dict(half_res=half_res, white_background=white_background)
    got, want = getattr(blender, loader)(base, **kw), getattr(jblender, loader)(base, **kw)
    _assert_same(got, want)
    imgs = got[0]["train"] if isinstance(got[0], dict) else got[0]
    assert imgs.shape[1:3] == ((9, 9) if half_res else (18, 18))
    assert 0.0 < imgs.mean() < 1.0


def test_port_writer_writes_what_jax_writes(written, tmp_path):
    """The port's write_blender_dataset (its own PNG codec) writes the
    files JAX's writes (Pillow): the same json, .npy masks and pixels."""
    synthetic.write_blender_dataset(str(tmp_path), H=18, W=18, n_train=3, n_val=2, n_test=3,
                                    objects="chessboard_slow", white_background=False)
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                   for d, _, fs in os.walk(tmp_path) for f in fs)
    assert names == sorted(n for n in (os.path.relpath(os.path.join(d, f), written)
                                       for d, _, fs in os.walk(written) for f in fs)
                           if not n.startswith("dynamic"))
    for name in names:
        ours, theirs = str(tmp_path / name), str(written / name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(ours)),
                                          np.asarray(Image.open(theirs)))
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(ours), np.load(theirs))
        else:
            assert json.load(open(ours)) == json.load(open(theirs))


MODES = {"L": (0, None), "LA": (4, 2), "RGB": (2, 3), "RGBA": (6, 4)}


def _image(mode, h=11, w=13, seed=0):
    """Noise below a smooth ramp: every row filter finds rows it suits."""
    rng = np.random.RandomState(seed)
    c = MODES[mode][1]
    shape = (h, w) if c is None else (h, w, c)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    ramp = (np.arange(w) * 7 + np.arange(h)[:, None] * 3) % 256
    img[: h // 2] = (ramp[: h // 2] if c is None else ramp[: h // 2, :, None]).astype(np.uint8)
    return img


@pytest.mark.parametrize("mode", sorted(MODES))
def test_png_reads_what_pillow_writes(mode, tmp_path):
    for i, optimize in enumerate((False, True)):
        img = _image(mode, seed=i)
        path = str(tmp_path / f"{mode}{i}.png")
        Image.fromarray(img, mode).save(path, optimize=optimize)
        got = png.read_png(path)
        want = np.asarray(Image.open(path))
        assert got.dtype == np.uint8 and got.shape == want.shape == img.shape
        np.testing.assert_array_equal(got, want)


def _filtered_png(path, img, kinds):
    """An 8-bit RGB PNG whose row y uses filter kinds[y % len(kinds)]."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        kind = kinds[y % len(kinds)]
        up = x[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
                4: png._paeth(left, up, upleft)}[kind]
        rows.append(bytes([kind]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + png._chunk(b"IHDR", header)
                + png._chunk(b"IDAT", zlib.compress(b"".join(rows))) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_png_undoes_each_row_filter(kinds, tmp_path):
    img = _image("RGB", h=9, w=10, seed=5)
    path = str(tmp_path / "f.png")
    _filtered_png(path, img, kinds)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)  # a valid file
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pillow_reads_what_png_writes(mode, tmp_path):
    img = _image(mode, h=17, w=6, seed=2)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("kind", ["palette", "16-bit", "interlaced", "not a png"])
def test_png_refuses_what_it_does_not_read(kind, tmp_path):
    path = str(tmp_path / "x.png")
    if kind == "palette":
        Image.fromarray(_image("RGB")).convert("P").save(path)
    elif kind == "16-bit":
        Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    elif kind == "interlaced":
        png.write_png(path, _image("RGB"))
        data = bytearray(open(path, "rb").read())
        data[28] = 1  # IHDR's interlace byte; mend its CRC
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        open(path, "wb").write(bytes(data))
    else:
        open(path, "wb").write(b"GIF89a")
    with pytest.raises(ValueError):
        png.read_png(path)
