"""Velocity-field accuracy against the synthetic scenes' exact field.

The port of ``nvfi_tpu/eval/velocity_eval.py:21-116``.  The synthetic scene
knows the exact rigid velocity at every point (``data.synthetic.scene_velocity``),
so the learned field is scored directly: the mean end-point error (EPE) over
points inside the objects, and the displacement error of RK2 advection over a
time interval.  The points are drawn on the host from the JAX package's
``np.random.RandomState(seed)`` stream, so both packages score the same
points; the velocity net (and the advection) runs on the params' device, the
rest stays numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.synthetic import _rot_axis, scene_velocity
from ..fields import kplane
from ..fields import velocity as vel_mod


def _normalize(meta: kplane.KPlaneMeta, pts: np.ndarray) -> np.ndarray:
    """World -> normalized coords in numpy, as the JAX package takes them
    (``nvfi_tpu/fields/kplane.py:413-416`` on a host array)."""
    a = meta.aabb_np
    return (pts - a[0]) * (2.0 / (a[1] - a[0])) - 1.0


def _denormalize(meta: kplane.KPlaneMeta, xyz_norm: np.ndarray) -> np.ndarray:
    a = meta.aabb_np
    return (xyz_norm + 1.0) * (a[1] - a[0]) / 2.0 + a[0]


def _device_of(params) -> torch.device:
    return params["vel"]["weight_net"][0]["w"].device


def velocity_epe(params, meta: kplane.KPlaneMeta, objects, t: float,
                 n_pts: int = 4096, seed: int = 0) -> dict:
    """Mean |v_pred - v_true| over points inside the objects at time t.

    Compared in world units: the field predicts velocity in normalized grid
    coordinates per unit time, so the predictions are scaled by
    aabb_size / 2 first."""
    rng = np.random.RandomState(seed)
    pts, obj_id = [], []
    for oi, obj in enumerate(objects):
        c = obj.center(t)
        d = rng.randn(n_pts // len(objects), 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        if getattr(obj, "hollow", False):
            # material lives only on the shell band (an enclosing room)
            r = obj.r - obj.SHELL * rng.rand(len(d), 1)
        else:
            r = obj.r * rng.rand(len(d), 1) ** (1 / 3)
        pts.append(c + d * r)
        obj_id.append(np.full(len(d), oi))
    pts = np.concatenate(pts).astype(np.float32)
    obj_id = np.concatenate(obj_id)

    v_true = scene_velocity(objects, pts, t)

    dev = _device_of(params)
    xyz_norm = torch.as_tensor(np.asarray(_normalize(meta, pts), np.float32), device=dev)
    tt = torch.full((len(pts), 1), t, dtype=torch.float32, device=dev)
    with torch.no_grad():
        v_pred_norm = vel_mod.gated_velocity(params["vel"], meta.vel_gate, xyz_norm, tt)
    scale = meta.aabb_size / 2.0  # normalized -> world units
    v_pred = v_pred_norm.cpu().numpy() * scale

    epe = np.linalg.norm(v_pred - v_true, axis=-1)
    speed = np.linalg.norm(v_true, axis=-1)
    moving = np.array([np.any(o.omega) or np.any(o.v_lin) for o in objects])
    mov = moving[obj_id]
    return {
        "epe_mean": float(epe.mean()),
        "epe_median": float(np.median(epe)),
        "true_speed_mean": float(speed.mean()),
        "relative_epe": float(epe.mean() / max(speed.mean(), 1e-9)),
        # split over moving and static material: the headline relative_epe
        # dilutes as static geometry (a room, walls) is added to a scene
        "epe_moving": float(epe[mov].mean()) if mov.any() else 0.0,
        "rel_epe_moving": float(epe[mov].mean() / max(speed[mov].mean(), 1e-9))
        if mov.any() else 0.0,
        "epe_static": float(epe[~mov].mean()) if (~mov).any() else 0.0,
    }


def advection_error(params, meta: kplane.KPlaneMeta, objects, t0: float, t1: float,
                    n_pts: int = 2048, seed: int = 0) -> dict:
    """Displacement error of RK2 advection from t1 back to t0
    (``meta.max_adv_steps`` steps) against the exact rigid motion of each
    object."""
    rng = np.random.RandomState(seed)
    pts0, pts1 = [], []
    for obj in objects:
        d = rng.randn(n_pts // len(objects), 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        if getattr(obj, "hollow", False):
            r = obj.r - obj.SHELL * rng.rand(len(d), 1)
        else:
            r = obj.r * 0.8 * rng.rand(len(d), 1) ** (1 / 3)
        local = d * r
        c0, c1 = obj.center(t0), obj.center(t1)
        # rigid: the offset rotates with the object
        w = np.linalg.norm(obj.omega)
        if w > 0:
            R0 = _rot_axis(obj.omega / w, w * t0)
            R1 = _rot_axis(obj.omega / w, w * t1)
            pts0.append(c0 + local @ R0.T)
            pts1.append(c1 + local @ R1.T)
        else:
            pts0.append(c0 + local)
            pts1.append(c1 + local)
    pts0 = np.concatenate(pts0).astype(np.float32)
    pts1 = np.concatenate(pts1).astype(np.float32)

    dev = _device_of(params)
    xyz1 = torch.as_tensor(np.asarray(_normalize(meta, pts1), np.float32), device=dev)
    t = torch.full((len(pts1), 1), t1, dtype=torch.float32, device=dev)
    base = torch.full_like(t, t0)
    with torch.no_grad():
        adv = kplane.integrate_pos(params, meta, xyz1, t, base, n_steps=meta.max_adv_steps)
    adv_world = _denormalize(meta, adv.cpu().numpy())
    err = np.linalg.norm(adv_world - pts0, axis=-1)
    disp = np.linalg.norm(pts1 - pts0, axis=-1)
    return {
        "adv_err_mean": float(err.mean()),
        "adv_err_median": float(np.median(err)),
        "displacement_mean": float(disp.mean()),
    }
