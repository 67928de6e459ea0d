"""``nvfi_torch.eval.velocity_eval`` held against the JAX package's on the
CPU: the velocity end-point error and the advection error of the same
params (the seeded scene of ``test_torch_occupancy``, whose velocity net is
scaled up so that advection moves points) against the exact rigid field of
two synthetic object sets, every returned number within rtol 1e-5.  The bat
set holds moving and static spheres; chessboard's adds a hollow room, whose
points lie on its shell band."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nvfi_tpu.data import synthetic as jsynthetic
from nvfi_tpu.eval import velocity_eval as jvelocity_eval
from nvfi_torch.data import synthetic
from nvfi_torch.eval import velocity_eval
from nvfi_torch.train.checkpoint import params_from_numpy

from test_torch_occupancy import scene

OBJECTS = {"bat": "default_objects", "chessboard": "chessboard_objects"}
# the MLP's f32 sums associate differently in XLA and torch; means over
# thousands of points
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _objects(name):
    return (getattr(jsynthetic, OBJECTS[name])(), getattr(synthetic, OBJECTS[name])())


def _assert_dicts_close(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("objects", sorted(OBJECTS))
@pytest.mark.parametrize("t", [0.2, 0.7])
def test_velocity_epe_matches_jax(objects, t):
    tree, jmeta, tmeta = scene()
    jobj, tobj = _objects(objects)
    want = jvelocity_eval.velocity_epe(jax.tree.map(jnp.asarray, tree), jmeta, jobj, t,
                                       n_pts=1500, seed=3)
    got = velocity_eval.velocity_epe(params_from_numpy(tree, "cpu"), tmeta, tobj, t,
                                     n_pts=1500, seed=3)
    _assert_dicts_close(got, want)
    # both kinds of material are scored, and the prediction is not trivially 0
    assert want["epe_moving"] > 0 and want["epe_static"] > 0
    assert want["epe_mean"] != pytest.approx(want["true_speed_mean"], rel=1e-3)


@pytest.mark.parametrize("objects", sorted(OBJECTS))
def test_advection_error_matches_jax(objects):
    tree, jmeta, tmeta = scene()
    jobj, tobj = _objects(objects)
    want = jvelocity_eval.advection_error(jax.tree.map(jnp.asarray, tree), jmeta, jobj, 0.0,
                                          0.5, n_pts=1200, seed=4)
    got = velocity_eval.advection_error(params_from_numpy(tree, "cpu"), tmeta, tobj, 0.0, 0.5,
                                        n_pts=1200, seed=4)
    _assert_dicts_close(got, want)
    assert want["displacement_mean"] > 0.05 and jmeta.max_adv_steps > 1


def test_hollow_room_points_lie_on_its_shell():
    """The points of a hollow object come from its shell band, so its exact
    velocity (``scene_velocity``) claims them: drawn from the same stream as
    the evaluation's, every one is material of the room."""
    _, tobj = _objects("chessboard")
    room = next(o for o in tobj if o.hollow)
    rng = np.random.RandomState(0)
    d = rng.randn(500, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = room.center(0.3) + d * (room.r - room.SHELL * rng.rand(500, 1))
    assert room.contains(pts.astype(np.float32), 0.3).all()
