"""Synthetic dynamic scene generator (analytic ray-traced rigid spheres).

The port's own copy of ``nvfi_tpu/data/synthetic.py`` (numpy on the host):
rigid spheres under exact rigid motions, ray-traced analytically per frame,
give posed multi-view video in the blender dict-of-splits layout, exact
instance masks and the exact velocity field.  Given the same arguments every
function returns the JAX package's arrays bit for bit (the same numpy calls
in the same order).  ``write_blender_dataset`` exports a scene as PNGs and
``transforms_*.json`` through the port's own PNG codec (``utils/png.py``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..render.rays import ray_bundle
from ..utils.png import write_png
from .blender import _spherical_pose


def _rot_axis(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return (np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K).astype(np.float32)


class RigidSphere:
    """A sphere with center c0, radius r, color, and rigid motion:
    rotation with angular velocity ``omega`` (rad/s vector) about ``pivot``
    plus linear velocity ``v_lin``.

    ``hollow=True`` makes it a thin SHELL rendered from inside (an enclosing
    room): ray-tracing takes the far intersection when the camera is interior,
    and only the shell band counts as material for velocity/occupancy queries.
    ``tex_freq > 0`` modulates the albedo with a smooth sinusoid evaluated in
    the object's REST frame (``rest_point``), so the pattern rides the rigid
    motion like a painted texture: it makes the motion photometrically
    observable inside a mover, not only at its silhouette.  ``tex_amp`` sets
    the modulation depth (albedo x [1-2*amp, 1])."""

    SHELL = 0.08  # hollow material band, world units

    def __init__(self, center, radius, color, omega=(0, 0, 0), pivot=(0, 0, 0),
                 v_lin=(0, 0, 0), hollow=False, tex_freq=0.0, tex_amp=0.25):
        self.c0 = np.asarray(center, np.float32)
        self.r = float(radius)
        self.color = np.asarray(color, np.float32)
        self.omega = np.asarray(omega, np.float32)
        self.pivot = np.asarray(pivot, np.float32)
        self.v_lin = np.asarray(v_lin, np.float32)
        self.hollow = bool(hollow)
        self.tex_freq = float(tex_freq)
        self.tex_amp = float(tex_amp)

    def center(self, t: float) -> np.ndarray:
        w = np.linalg.norm(self.omega)
        piv = self.pivot + self.v_lin * t
        if w > 0:
            R = _rot_axis(self.omega / w, w * t)
            return R @ (self.c0 - self.pivot) + piv
        return self.c0 + self.v_lin * t

    def rest_point(self, x: np.ndarray, t: float) -> np.ndarray:
        """Inverse rigid map: world point at time t -> the same material point
        at t=0 (the frame textures are painted in).  Inverse of ``center``'s
        forward map p(t) = R(t) @ (p0 - pivot) + pivot + v_lin*t."""
        piv = self.pivot + self.v_lin * t
        w = np.linalg.norm(self.omega)
        if w > 0:
            Rinv = _rot_axis(self.omega / w, -w * t)
            return (x - piv) @ Rinv.T + self.pivot
        return x - piv + self.pivot

    def velocity(self, x: np.ndarray, t: float) -> np.ndarray:
        """Exact rigid velocity at points x (..., 3) at time t."""
        piv = self.pivot + self.v_lin * t
        return np.cross(np.broadcast_to(self.omega, x.shape), x - piv) + self.v_lin

    def contains(self, x: np.ndarray, t: float) -> np.ndarray:
        """Material-occupancy mask at points x (..., 3): the full ball for
        solid spheres, only the shell band for hollow ones."""
        d = np.linalg.norm(x - self.center(t), axis=-1)
        if self.hollow:
            return np.abs(d - self.r) <= self.SHELL
        return d <= self.r


def default_objects():
    """A bat-like stand-in: one orbiting sphere, one translating, one static."""
    return [
        RigidSphere(
            center=(0.9, 0.0, 0.3), radius=0.45, color=(0.9, 0.25, 0.2),
            omega=(0, 0, 2.5), pivot=(0, 0, 0.3),
        ),
        RigidSphere(
            center=(-0.8, -0.6, -0.4), radius=0.4, color=(0.2, 0.5, 0.9),
            v_lin=(0.9, 0.7, 0.3),
        ),
        RigidSphere(center=(0.0, 0.9, -0.7), radius=0.5, color=(0.3, 0.85, 0.3)),
    ]


def fan_objects():
    """A fan-like donor scene for cross-scene motion transfer: three 'blade'
    spheres orbiting the z-axis about a hub, plus the static hub.  Kept inside
    a TIGHTER aabb (use bbox +-1.5, configs/synth/fan.yaml) than the bat scene,
    so grafting its velocity into a +-2 scene exercises the normalized-
    coordinate mismatch."""
    blades = []
    for k in range(3):
        a = 2.0 * np.pi * k / 3.0
        blades.append(RigidSphere(
            center=(0.75 * np.cos(a), 0.75 * np.sin(a), 0.15),
            radius=0.28,
            color=((0.9, 0.6, 0.15), (0.2, 0.7, 0.9), (0.75, 0.3, 0.8))[k],
            omega=(0, 0, 4.0), pivot=(0, 0, 0.15),
        ))
    hub = RigidSphere(center=(0.0, 0.0, 0.15), radius=0.3, color=(0.6, 0.6, 0.62))
    return blades + [hub]


def chessboard_objects():
    """An InDoorSeg-style stand-in for the 'sur'-gated scene family
    (config/InDoorSeg/chessboard.yaml: black bg, K=4, VelocityAABBSur with
    sur_x/y/z = +-1.6 inside bbox +-2.02): moving 'pieces' that stay INSIDE
    the surround box, a static piece inside it, a static 'wall' sphere
    OUTSIDE the surround box — the gate must hold its velocity at exactly
    zero (reference models/velocity_field.py:36-51) — and an enclosing ROOM
    shell observed from inside.

    The room makes the stand-in representative: the reference's InDoorSeg
    scenes are closed rooms where every ray ends on geometry (4 in-room
    cameras; the black background is never visible)."""
    return [
        # piece orbiting the board center, radius 0.9 < sur 1.6 - size
        RigidSphere(center=(0.9, 0.0, 0.0), radius=0.35, color=(0.9, 0.8, 0.75),
                    omega=(0, 0, 2.0), pivot=(0, 0, 0.0)),
        # piece sliding diagonally across the board, ends well inside sur
        RigidSphere(center=(-1.0, -1.0, -0.45), radius=0.3,
                    color=(0.15, 0.15, 0.2), v_lin=(1.2, 1.2, 0.5)),
        # static piece inside the surround box
        RigidSphere(center=(0.0, 0.9, 0.55), radius=0.35, color=(0.75, 0.2, 0.2)),
        # static 'wall' bump OUTSIDE the surround box (|y| > 1.6): sur-gated
        # velocity is identically zero here
        RigidSphere(center=(0.0, -1.85, 0.0), radius=0.16, color=(0.3, 0.6, 0.35)),
        # the room: hollow textured shell between sur (1.6) and bbox (2.02),
        # static geometry outside the gate, seen from interior cameras
        RigidSphere(center=(0.0, 0.0, 0.0), radius=1.9, color=(0.58, 0.55, 0.5),
                    hollow=True, tex_freq=2.5),
    ]


def carousel_objects():
    """Second InDoorSeg-family stand-in (sur-gated, black bg, K=4): a
    two-sphere platter rotating the OPPOSITE way from the chessboard's
    orbiter plus a slow riser, a static hub, and a static wall outside the
    surround box: a donor for motion transfer within the sur family, with
    motion visibly distinct from the chessboard host."""
    return [
        RigidSphere(center=(1.0, 0.0, 0.2), radius=0.34, color=(0.85, 0.75, 0.3),
                    omega=(0, 0, -1.8), pivot=(0, 0, 0.2)),
        RigidSphere(center=(-0.7, 0.7, -0.3), radius=0.3, color=(0.35, 0.8, 0.85),
                    omega=(0, 0, -1.8), pivot=(0, 0, -0.3), v_lin=(0, 0, 0.5)),
        RigidSphere(center=(0.0, 0.0, 0.0), radius=0.32, color=(0.8, 0.35, 0.6)),
        # static wall bump fully outside the sur box (x-0.16 > 1.6) but poking
        # through the room shell (|c| = 1.82 < 1.9) so interior cameras see it
        RigidSphere(center=(1.8, 0.0, 0.3), radius=0.16, color=(0.4, 0.55, 0.4)),
        # same room shell as the chessboard host (see chessboard_objects)
        RigidSphere(center=(0.0, 0.0, 0.0), radius=1.9, color=(0.55, 0.57, 0.52),
                    hollow=True, tex_freq=2.0),
    ]


def _texture_movers(objects, tex_freq=5.0, tex_amp=0.45):
    """Give every solid piece a strong rest-frame texture (the room shell
    keeps its own): interior texture makes the between-keyframe advection
    offset photometrically observable everywhere on the piece, not just at
    its silhouette."""
    for obj in objects:
        if not obj.hollow:
            obj.tex_freq, obj.tex_amp = tex_freq, tex_amp
    return objects


def chessboard_tex_objects():
    """Textured variant of the chessboard stand-in (see _texture_movers)."""
    return _texture_movers(chessboard_objects())


def carousel_tex_objects():
    """Textured variant of the carousel stand-in (transfer donor)."""
    return _texture_movers(carousel_objects())


def _scale_speed(objects, s):
    """Scale every object's rigid motion rates by ``s`` (trajectories start
    at the same t=0 poses; angular and linear speeds shrink together, so the
    exact velocity field scales by exactly ``s``)."""
    for obj in objects:
        obj.omega = obj.omega * s
        obj.v_lin = obj.v_lin * s
    return objects


# The K=4 keyframe spacing of the InDoorSeg family (Δ = tmax/3 = 0.25) means
# samples advect across offsets up to Δ/2 = 0.125 time units.  The stand-in
# movers travel ~0.225 units (~65% of a piece radius) per such offset, outside
# the photometric gradient basin of the advection path; the ``_slow`` variants
# scale mover speed by 0.2, so every mover's worst-point displacement per
# offset stays within 25% of its radius, the regime bat trains in.
SUR_SPEED_CALIBRATION = 0.2


def chessboard_slow_objects():
    """Speed-calibrated textured chessboard stand-in (see above)."""
    return _scale_speed(chessboard_tex_objects(), SUR_SPEED_CALIBRATION)


def carousel_slow_objects():
    """Speed-calibrated textured carousel stand-in (transfer donor)."""
    return _scale_speed(carousel_tex_objects(), SUR_SPEED_CALIBRATION)


SCENE_OBJECTS = {"bat": default_objects, "fan": fan_objects,
                 "chessboard": chessboard_objects,
                 "carousel": carousel_objects,
                 "chessboard_tex": chessboard_tex_objects,
                 "carousel_tex": carousel_tex_objects,
                 "chessboard_slow": chessboard_slow_objects,
                 "carousel_slow": carousel_slow_objects}

# Per-scene camera presets (applied when make_synthetic_scene is given a
# scene NAME).  The sur-gated indoor scenes put the cameras INSIDE the room
# (between the movers at <=1.25 and the shell at 1.9) with a wide indoor
# field of view, like the reference's in-room corner cameras; the open scenes
# keep the original outside-in orbit (radius 4, blender default fov).
SCENE_CAMERA = {
    "chessboard": {"radius": 1.6, "fov": 1.25, "n_cams": 4},
    "carousel": {"radius": 1.6, "fov": 1.25, "n_cams": 4},
    "chessboard_tex": {"radius": 1.6, "fov": 1.25, "n_cams": 4},
    "carousel_tex": {"radius": 1.6, "fov": 1.25, "n_cams": 4},
    "chessboard_slow": {"radius": 1.6, "fov": 1.25, "n_cams": 4},
    "carousel_slow": {"radius": 1.6, "fov": 1.25, "n_cams": 4},
}


def render_frame(objects, pose, H, W, focal, t, white_background=True, light=(0.5, 0.5, 1.0)):
    """Analytic ray trace: returns (rgb (H,W,3), segm (H,W) int32 with 0=bg)."""
    rays_o, rays_d = ray_bundle(pose, H, W, focal)
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)

    best_t = np.full(o.shape[0], np.inf, dtype=np.float32)
    best_id = np.zeros(o.shape[0], dtype=np.int32)
    best_n = np.zeros_like(o)
    for idx, obj in enumerate(objects):
        c = obj.center(t)
        oc = o - c
        b = np.sum(oc * dn, axis=-1)
        disc = b * b - (np.sum(oc * oc, axis=-1) - obj.r**2)
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0))
        # nearest POSITIVE root: entry point from outside, exit point when the
        # ray starts inside (a hollow room sphere seen from its interior)
        t_near, t_far = -b - sq, -b + sq
        t_hit = np.where(t_near > 1e-3, t_near, t_far)
        hit &= t_hit > 1e-3
        closer = hit & (t_hit < best_t)
        best_t = np.where(closer, t_hit, best_t)
        best_id = np.where(closer, idx + 1, best_id)
        p = o + dn * t_hit[..., None]
        n = (p - c) / obj.r
        # interior hits shade with the inward-facing normal
        n = np.where(np.sum(n * dn, axis=-1, keepdims=True) > 0, -n, n)
        best_n = np.where(closer[..., None], n, best_n)

    lightv = np.asarray(light, np.float32)
    lightv = lightv / np.linalg.norm(lightv)
    shade = 0.4 + 0.6 * np.maximum(np.sum(best_n * lightv, axis=-1), 0.0)

    colors = np.concatenate(
        [np.zeros((1, 3), np.float32)] + [obj.color[None] for obj in objects]
    )
    rgb = colors[best_id] * shade[..., None]
    # rest-frame albedo texture where requested (see RigidSphere.tex_freq):
    # the hit point is pulled back through the object's inverse rigid map so
    # the pattern moves WITH the object (identical to world-space for statics)
    hit_p = o + dn * np.where(np.isfinite(best_t), best_t, 0.0)[..., None]
    for idx, obj in enumerate(objects):
        if obj.tex_freq > 0.0:
            f = obj.tex_freq * np.pi
            p0 = obj.rest_point(hit_p, t)
            tex = (1.0 - obj.tex_amp) + obj.tex_amp * (
                np.sin(f * p0[..., 0]) * np.sin(f * p0[..., 1]) * np.sin(f * p0[..., 2]))
            rgb = np.where((best_id == idx + 1)[..., None], rgb * tex[..., None], rgb)
    bg = 1.0 if white_background else 0.0
    rgb = np.where((best_id == 0)[..., None], bg, rgb)
    return (
        rgb.reshape(H, W, 3).astype(np.float32),
        best_id.reshape(H, W).astype(np.int32),
    )


def scene_velocity(objects, x: np.ndarray, t: float) -> np.ndarray:
    """Exact scene velocity at points inside object material (0 elsewhere).
    Hollow shells only claim their shell band (RigidSphere.contains), so an
    enclosing room never masks the movers it contains."""
    v = np.zeros_like(x)
    for obj in objects:
        v = np.where(obj.contains(x, t)[..., None], obj.velocity(x, t), v)
    return v


def make_synthetic_scene(
    n_train=24, n_val=4, n_test=8, H=64, W=64, n_times=16, tmax_frac=0.75,
    white_background=True, objects=None, radius=None, fov=None, seed=0,
    heldout_test=False,
):
    """Build an in-memory dataset with the reference loader's return layout.

    Train covers t in [0, tmax_frac]; test extends to t=1 (extrapolation split,
    reference config/InDoorObj/bat.yaml:137).  Returns the standard 7-tuple
    plus a dict of extras (objects, segm masks per split).  Camera radius and
    field of view default to the scene's SCENE_CAMERA preset (outside-in
    orbit at 4.0 / blender fov for open scenes; in-room cameras for the
    indoor sur-gated scenes).

    ``heldout_test`` (fixed-camera rig scenes only): the reference's test
    protocol is per-FIXED-camera — ``transforms_test.json`` holds a handful
    of static held-out viewpoints each recording the full time range
    (datasets/load_blender_dynamic.py:89-100 keys test frames by camera,
    one ``transform_matrix`` per camera), NOT a free orbit.  The default
    orbit test split sweeps 360° of never-observed interior viewpoints and
    so reports the 4-camera rig's worst-case novel-view PSNR; with
    ``heldout_test=True`` the test split instead uses two fixed held-out
    interior cameras (thetas interleaved between the train rig's) sampling
    the same test times — the protocol-matched number.  Velocity/advection
    metrics are camera-independent and identical under both.
    """
    cam = {}
    if isinstance(objects, str):
        cam = SCENE_CAMERA.get(objects, {})
        objects = SCENE_OBJECTS[objects]()
    elif objects is None:
        objects = default_objects()
    radius = cam.get("radius", 4.0) if radius is None else radius
    fov = cam.get("fov", 0.6911112) if fov is None else fov  # blender default
    rng = np.random.RandomState(seed)
    focal = 0.5 * W / np.tan(0.5 * fov)

    def make_split(n, t_lo, t_hi, phase):
        times = np.linspace(t_lo, t_hi, n).astype(np.float32)
        thetas = np.linspace(-180, 180, n, endpoint=False) + phase
        imgs, poses, segms = [], [], []
        for t, th in zip(times, thetas):
            phi = -30.0 + 15.0 * np.sin(th / 60.0)
            pose = _spherical_pose(th, phi, radius)
            rgb, segm = render_frame(objects, pose, H, W, focal, float(t), white_background)
            imgs.append(rgb)
            poses.append(pose)
            segms.append(segm)
        return np.stack(imgs), poses, times.tolist(), np.stack(segms)

    # keyframe-aligned training times: include t=0 and hit keyframes exactly
    train_times = np.linspace(0.0, tmax_frac, n_train).astype(np.float32)
    n_cams = int(cam.get("n_cams", 0))
    imgs, poses, segms = [], [], []
    if n_cams:
        # Fixed multi-camera rig (the reference's InDoorSeg capture protocol:
        # each camera has ONE pose and records EVERY timestep); a monocular
        # moving camera inside the room would see each timestep from one view.
        cam_thetas = np.linspace(-180.0, 180.0, n_cams, endpoint=False) + 45.0
        cam_phis = [-35.0, -20.0, -30.0, -25.0]
        times_l = []
        for k, th in enumerate(cam_thetas):
            pose = _spherical_pose(float(th), cam_phis[k % len(cam_phis)], radius)
            for t in train_times:
                rgb, segm = render_frame(objects, pose, H, W, focal, float(t), white_background)
                imgs.append(rgb)
                poses.append(pose)
                segms.append(segm)
                times_l.append(float(t))
        train = (np.stack(imgs), poses, times_l, np.stack(segms))
    else:
        thetas = rng.uniform(-180, 180, n_train)
        for t, th in zip(train_times, thetas):
            pose = _spherical_pose(float(th), -30.0 + float(rng.uniform(-10, 10)), radius)
            rgb, segm = render_frame(objects, pose, H, W, focal, float(t), white_background)
            imgs.append(rgb)
            poses.append(pose)
            segms.append(segm)
        train = (np.stack(imgs), poses, train_times.tolist(), np.stack(segms))

    val = make_split(n_val, 0.0, tmax_frac, 13.0)
    if heldout_test and n_cams:
        # reference protocol: fixed held-out cameras, every test time recorded
        # from a static viewpoint interleaved between the train rig's thetas
        # 90/-90 interleave the rig's [-135,-45,45,135] and keep the movers
        # in frame in both sur scenes (theta=0 stares at a static piece)
        ho_thetas, ho_phis = (90.0, -90.0), (-28.0, -32.0)
        ho_poses = [_spherical_pose(th, ph, radius)
                    for th, ph in zip(ho_thetas, ho_phis)]
        times = np.linspace(0.0, 1.0, n_test).astype(np.float32)
        imgs, poses, segms = [], [], []
        for i, t in enumerate(times):
            pose = ho_poses[i % len(ho_poses)]
            rgb, segm = render_frame(objects, pose, H, W, focal, float(t), white_background)
            imgs.append(rgb)
            poses.append(pose)
            segms.append(segm)
        test = (np.stack(imgs), poses, times.tolist(), np.stack(segms))
    else:
        test = make_split(n_test, 0.0, 1.0, 29.0)  # extends beyond tmax: extrapolation

    all_imgs = {"train": train[0], "val": val[0], "test": test[0]}
    all_poses = {"train": train[1], "val": val[1], "test": test[1]}
    all_times = {"train": train[2], "val": val[2], "test": test[2]}
    segm = {"train": train[3], "val": val[3], "test": test[3]}

    init_sel = [i for i, t in enumerate(all_times["train"]) if t == 0.0]
    all_imgs["init"] = all_imgs["train"][init_sel]
    all_poses["init"] = [all_poses["train"][i] for i in init_sel]
    all_times["init"] = [all_times["train"][i] for i in init_sel]
    counts = {s: len(all_times[s]) for s in all_times}

    render_poses = np.stack([_spherical_pose(a, -30.0, radius) for a in np.linspace(-180, 180, 9)[:-1]])
    render_times = np.linspace(0, 1, 8).astype(np.float32)
    extras = {"objects": objects, "segm": segm, "tmax": tmax_frac}
    return all_imgs, all_poses, all_times, counts, render_poses, render_times, [H, W, focal], extras


def write_blender_dataset(outdir, H=64, W=64, **kwargs):
    """Export the synthetic scene in the reference's on-disk blender format
    (transforms_{train,val,test}.json + PNGs + GT segm .npy), loadable by both
    this framework and the PyTorch reference."""
    data = make_synthetic_scene(H=H, W=W, **kwargs)
    all_imgs, all_poses, all_times, counts, _, _, (h, w, focal), extras = data
    camera_angle_x = 2.0 * np.arctan(0.5 * w / focal)
    os.makedirs(outdir, exist_ok=True)
    for split in ("train", "val", "test"):
        frames = []
        os.makedirs(os.path.join(outdir, split), exist_ok=True)
        for i in range(counts[split]):
            rel = f"{split}/r_{i:03d}"
            img = (all_imgs[split][i] * 255).astype(np.uint8)
            # RGBA like real blender dumps: alpha = object coverage, so the
            # reference loader's compositing (load_blender.py:99-104) works
            alpha = (extras["segm"][split][i] > 0).astype(np.uint8) * 255
            rgba = np.concatenate([img, alpha[..., None]], axis=-1)
            write_png(os.path.join(outdir, rel + ".png"), rgba)
            np.save(os.path.join(outdir, rel + "_segm.npy"), extras["segm"][split][i])
            frames.append(
                {
                    "file_path": rel,
                    "img_path": rel,
                    "segm_path": rel + "_segm",
                    "time": float(all_times[split][i]),
                    "transform_matrix": np.asarray(all_poses[split][i]).tolist(),
                }
            )
        with open(os.path.join(outdir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(camera_angle_x), "frames": frames}, f)
    # flat variant for the segm loaders
    with open(os.path.join(outdir, "transforms.json"), "w") as f:
        frames = []
        for i in range(counts["test"]):
            rel = f"test/r_{i:03d}"
            frames.append(
                {
                    "img_path": rel,
                    "segm_path": rel + "_segm",
                    "time": float(all_times["test"][i]),
                    "transform_matrix": np.asarray(all_poses["test"][i]).tolist(),
                }
            )
        json.dump({"camera_angle_x": float(camera_angle_x), "frames": frames}, f)
    return data
