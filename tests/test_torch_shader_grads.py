"""A training render's colour loss and its per-leaf gradients in every
shading mode of nvfi_torch and with DensityLinear (ROADMAP A3), held against
``jax.grad`` on the CPU: the scene of ``test_torch_shaders``, JAX's
stratified jitter injected, the gradient tolerances of ``test_torch_train``.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.fields import kplane as jkplane
from nvfi_torch.fields import kplane, shaders
from nvfi_torch.train import checkpoint

import test_torch_render
from test_torch_shaders import IDS, MODES, T, _jp, _scene
from test_torch_train import _assert_trees_close, _flat


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Eager steps slow down several times beside other workers at torch's
    default of a thread a core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jitter_from_key(key, n, S):
    """JAX render_rays' box jitter for ``key`` (its stratified half)."""
    k_strat, _ = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_strat, (n, 1), jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_loss_grad(jmeta):
    def loss(params, key, o, d, target):
        out = jkplane.render_rays(params, jmeta, jnp.float32(T), o, d, key=key, training=True,
                                  white_bg=True)
        return jnp.mean((out["rgb"] - target) ** 2)

    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("shading,density", MODES, ids=IDS)
def test_train_loss_grads_match_jax(shading, density):
    """A training render's colour loss and its per-leaf gradients (planes,
    both bases, the shader where it has params, the velocity net) against
    ``jax.grad``, JAX's stratified jitter injected."""
    tree, jmeta, tmeta = _scene(shading, density)
    o, d = test_torch_render._rays(n=32)
    target = np.random.RandomState(5).uniform(0, 1, (32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    want_loss, want = _jax_loss_grad(jmeta)(_jp(tree), key, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(target))
    params = kplane.map_params(lambda x: x.requires_grad_(True),
                               checkpoint.params_from_numpy(tree, "cpu"))
    out = kplane.render_rays(params, tmeta, T, o, d, white_bg=True, training=True,
                             jitter=_jitter_from_key(key, 32, tmeta.n_samples), device="cpu")
    loss = torch.mean((out["rgb"] - torch.tensor(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    grads = kplane.map_params(lambda p: p.grad, params)
    if shading in shaders.ANALYTIC_SHADERS:  # no params, no gradient, on both sides
        assert grads.pop("shader") is None and want.pop("shader") is None
    _assert_trees_close(grads, want)
    # what the mode adds has a gradient: the shader's six leaves where it has
    # them, basis_mat_density with DensityLinear (Density leaves it unused)
    nonzero = {k for k, v in _flat(want).items() if v is not None and v.any()}
    assert sum(k.startswith("shader/") for k in nonzero) == (
        0 if shading in shaders.ANALYTIC_SHADERS else 6)
    assert ("basis_mat_density/w" in nonzero) == (density == "DensityLinear")
    assert {f"planes_space/{i}" for i in range(3)} | {"basis_mat/w"} <= nonzero
