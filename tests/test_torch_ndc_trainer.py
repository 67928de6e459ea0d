"""A short NDC ``Trainer`` run of nvfi_torch (ROADMAP A3) stepped beside the
JAX package's on the CPU: the forward-facing rig of
``tests/test_round5.py::test_ndc_training_e2e`` (the model in the NDC cube,
samples linear over NDC depth [0, 1]) at 16 x 16, the same params, frames
and random draws on both sides.
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.train import trainer as jtrainer
from nvfi_torch.config import CfgNode
from nvfi_torch.fields import kplane
from nvfi_torch.train import checkpoint, trainer

from test_train_e2e import small_cfg
from test_torch_ndc import H, NDC_CFG, W, _jax_draws, _rig_dataset, _two_threads  # noqa: F401
from test_torch_train import _pde_draws


def _draws_for(key, tmeta, hp):
    """The draws of JAX's loss for ``key``, by its key splits; the jitter of
    NDC sampling is one column a sample."""
    ray_chunk, n_chunks = trainer.ray_chunking(tmeta, hp)
    keys = jax.random.split(key, 4)

    def batch(k):
        k_pix, k_render = jax.random.split(k)
        pix = np.asarray(jax.random.choice(k_pix, H * W, (hp.n_rays,), replace=False))
        chunk_keys = [k_render] if n_chunks == 1 else jax.random.split(k_render, n_chunks)
        jitter = [_jax_draws("ndc", ck, ray_chunk, tmeta.n_samples) for ck in chunk_keys]
        return torch.tensor(pix, dtype=torch.int64), torch.tensor(np.stack(jitter))

    pix_t, jitter_t = batch(keys[0])
    pix_0, jitter_0 = batch(keys[1])
    points, times_u, noise = _pde_draws(keys[2], hp.vel_reg_n_pts)
    kv1, kv2 = jax.random.split(keys[3])
    probe_x = np.asarray(jax.random.uniform(kv1, (2048, 3), minval=-1.0, maxval=1.0))
    probe_t = np.asarray(jax.random.uniform(kv2, (2048, 1)))
    return trainer.TrainDraws(pix_t, pix_0, jitter_t, jitter_0, None, None, points, times_u,
                              noise, torch.tensor(probe_x), torch.tensor(probe_t))


class _JaxDraws:
    """``Trainer(draws=...)``: each step's draws from the JAX trainer's key chain."""

    def __init__(self, seed):
        self.key, _ = jax.random.split(jax.random.PRNGKey(seed))  # the init split

    def __call__(self, step, meta, hp):
        self.key, k_step = jax.random.split(self.key)
        return _draws_for(k_step, meta, hp)


def test_ndc_trainer_steps_with_jaxs():
    """The NDC Trainer on the forward-facing rig, three iterations beside
    JAX's Trainer (the same params, frames and draws): the same loss each
    iteration, and the training rays projected on the device."""
    jcfg = small_cfg(**NDC_CFG)
    tcfg = CfgNode(jcfg.to_dict())
    jds, tds = _rig_dataset()
    jtr = jtrainer.Trainer(jcfg, jds, mode="static_dynamic")
    ttr = trainer.Trainer(tcfg, tds, mode="static_dynamic", device="cpu", draws=_JaxDraws(0))
    assert jtr.meta.ray_sampling == ttr.meta.ray_sampling == "ndc"
    assert ttr.hp.ndc and ttr.hp.ndc_near == 1.0
    ttr.params = kplane.map_params(lambda x: x.detach().clone().requires_grad_(True),
                                   checkpoint.params_from_numpy(
                                       jax.tree.map(np.array, jtr.params), "cpu"))
    jlogs, tlogs = [], []
    for it in range(1, 4):  # one iteration a call, logged at its end
        jtr.train(iters=it, log_fn=jlogs.append)
        ttr.train(iters=it, log_fn=tlogs.append)
    assert len(jlogs) == len(tlogs) == 3
    for j, t in zip(jlogs, tlogs):
        for k in ("loss", "rgb_loss_t", "rgb_loss_0"):
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-4, err_msg=k)
    assert np.isfinite(tlogs[-1]["loss"])
