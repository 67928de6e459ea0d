"""Motion transfer and the segmentation head of nvfi_torch held against the
JAX package on the CPU: ``render_rays(transfer_vel=True)`` in the dense, the
top-K and the block-sparse arms (and in bf16 once), the t = 0 transfer frame
against the non-transfer one, the MaskField head composited along the ray,
``render_image`` with ``mask_params``, the transfer alpha mask
(``compute_dense_alpha`` / ``update_alpha_mask(transfer=True)``) and the
port's GIF writer.

The scene (a density blob, velocity scaled so that advection moves points
by a few cells) and its mask grid come from ``test_torch_occupancy``; the
turbo budgets and blocks of 12 from ``test_torch_turbo``.  Its K = 4 and
tmax 0.75 give ``transfer_adv_steps`` = 8, the segmentation configs' count.
Tolerances are the render's (``TOL`` of ``test_torch_render``), the mask map
the acc's; the dense alpha the mask build's (``ALPHA_ATOL``, rtol 1e-4).
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nvfi_tpu.config import load_config as jload_config
from nvfi_tpu.fields import kplane as jkplane
from nvfi_tpu.fields import mask_field as jmask_field
from nvfi_tpu.render.renderer import render_image as jrender_image
from nvfi_torch.config import load_config
from nvfi_torch.fields import kplane
from nvfi_torch.render import rays
from nvfi_torch.render.renderer import render_image
from nvfi_torch.train import checkpoint
from nvfi_torch.utils import gif

import test_torch_render
from test_torch_occupancy import ALPHA_ATOL, MASK_GRID, META, scene
from test_torch_turbo import BUDGET, SB, SHADE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(test_torch_render.TOL, mask=test_torch_render.TOL["acc"])
ARMS = {"dense": {}, "top_k": {"shade_fraction": SHADE},
        "block_sparse": {"sample_block": SB, "block_budget": BUDGET}}
MASK_DIM = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Many small eager ops: two threads beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rays(n=40):
    rng = np.random.RandomState(0)
    o = np.tile(np.array([[0.2, 0.6, 4.5]], np.float32), (n, 1))
    d = np.concatenate([rng.randn(n, 2).astype(np.float32) * 0.1,
                        -np.ones((n, 1), np.float32)], -1)
    return o, d


@functools.lru_cache(maxsize=None)
def jax_transfer_mask():
    """The JAX package's transfer mask of the scene, as numpy arrays."""
    tree, jmeta, _ = scene()
    state, _ = jkplane.update_alpha_mask(_jp(tree), jmeta, MASK_GRID, transfer=True)
    return {k: np.asarray(v) for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def jax_mask_params():
    """A MaskField of the trainer's depth (4 layers, narrower) from JAX's init."""
    tree = jmask_field.init(jax.random.PRNGKey(3), n_layer=4, n_dim=32, mask_dim=MASK_DIM)
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_render_fn(meta):
    return jax.jit(functools.partial(jkplane.render_rays, meta=meta, key=None, training=False,
                                     white_bg=True, transfer_vel=True))


def _metas(arm, **change):
    _, jmeta, tmeta = scene()
    change = {**ARMS[arm], **change}
    return dataclasses.replace(jmeta, **change), dataclasses.replace(tmeta, **change)


def _both(t, arm, head=False):
    """(JAX's transfer render, the port's) of the scene's rays at t, under
    the JAX transfer mask; ``head``: with the MaskField head."""
    tree, _, _ = scene()
    jmeta, tmeta = _metas(arm, mask_dim=MASK_DIM if head else 0)
    state = jax_transfer_mask()
    mp = jax_mask_params() if head else None
    o, d = _rays()
    want = _jax_render_fn(jmeta)(
        _jp(tree), t=jnp.float32(t), rays_o=jnp.asarray(o), rays_d=jnp.asarray(d),
        alpha_state={k: jnp.asarray(v) for k, v in state.items()},
        mask_params=None if mp is None else _jp(mp))
    got = kplane.render_rays(
        checkpoint.params_from_numpy(tree, "cpu"), tmeta, t, o, d, white_bg=True,
        transfer_vel=True, alpha_state=checkpoint.alpha_state_from_numpy(state, "cpu"),
        mask_params=None if mp is None else checkpoint.params_from_numpy(mp, "cpu"),
        device="cpu")
    return want, got


def _assert_close(got, want, keys):
    for k in keys:
        rtol, atol = TOL[k]
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


def test_transfer_step_counts_match_jax():
    """K = 16 (bat): 40 RK2 steps back to t = 0; K = 4 (the segmentation
    configs): 8; and the exact count at a host-known time."""
    for name, want in (("bat", 40), ("chessboard_slow_turbo", 8)):
        path = os.path.join(REPO, "configs", "synth", f"{name}.yaml")
        metas = []
        for load, mod in ((jload_config, jkplane), (load_config, kplane)):
            cfg = load(path)
            metas.append(mod.meta_from_cfg(cfg.nvfi, ((-1.0,) * 3, (1.0,) * 3), (8, 8, 8),
                                           (0.1, 4.0)))
        assert metas[0].transfer_adv_steps == metas[1].transfer_adv_steps == want
        for t in (0.0, 0.01, 0.3, 0.75, 1.0):
            assert (kplane.render_steps_for_time(metas[1], t, transfer=True)
                    == jkplane.render_steps_for_time(metas[0], t, transfer=True))


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("t", [0.0, 0.3, 1.0])
def test_transfer_render_rays_matches_jax(t, arm):
    want, got = _both(t, arm)
    _assert_close(got, want, ("rgb", "acc", "depth", "weight", "mask"))
    for k in ("dropped_blocks", "dropped_shade"):
        assert float(got[k]) == float(want[k]) == 0.0, k
    # at t = 1 the donor-free scene's blob has moved out of these rays
    assert float(np.asarray(want["acc"]).mean()) > (0.1 if t < 1.0 else 0.02)


@pytest.mark.parametrize("arm", list(ARMS))
def test_transfer_frame_at_t0_equals_the_plain_frame(arm):
    """At t = 0 the transfer render advects by a zero offset: with the same
    mask it is the host's own frame at t = 0, bit for bit (the correctness
    signal of the transfer driver), the head's map included."""
    tree, _, _ = scene()
    _, tmeta = _metas(arm, mask_dim=MASK_DIM)
    params = checkpoint.params_from_numpy(tree, "cpu")
    state = checkpoint.alpha_state_from_numpy(jax_transfer_mask(), "cpu")
    mp = checkpoint.params_from_numpy(jax_mask_params(), "cpu")
    o, d = _rays()
    out = [kplane.render_rays(params, tmeta, 0.0, o, d, white_bg=True, transfer_vel=transfer,
                              alpha_state=state, mask_params=mp, device="cpu")
           for transfer in (True, False)]
    for k in ("rgb", "acc", "depth", "weight", "mask", "z_vals"):
        assert torch.equal(out[0][k], out[1][k]), k
    # and elsewhere the two differ: the transfer arm really advects to t = 0
    later = [kplane.render_rays(params, tmeta, 0.6, o, d, white_bg=True, transfer_vel=transfer,
                                alpha_state=state, device="cpu") for transfer in (True, False)]
    assert float((later[0]["rgb"] - later[1]["rgb"]).abs().max()) > 1e-3


@pytest.mark.parametrize("arm", list(ARMS))
def test_mask_head_matches_jax(arm):
    """The MaskField at the advected (here the t = 0) positions, zeroed under
    rayMarch_weight_thres and summed against the weights (dense and
    block-sparse), or at the top-K samples against their weights."""
    want, got = _both(0.3, arm, head=True)
    _assert_close(got, want, ("rgb", "acc", "mask"))
    mask = got["mask"].numpy()
    assert mask.shape == (40, MASK_DIM)
    # softmax slots sum to 1 a sample: the map sums to the weight kept
    kept = torch.where(got["weight"] > META["raymarch_weight_thres"], got["weight"], 0.0)
    np.testing.assert_allclose(mask.sum(-1), kept.sum(-1).numpy(), rtol=1e-5, atol=1e-6)
    assert mask.sum(-1).max() > 0.1 and np.ptp(mask[mask.sum(-1) > 0.1], axis=0).max() > 1e-3


def test_the_head_reads_the_advected_position():
    """Under transfer the head reads each sample's t = 0 position: the map
    differs from one of the same head at the samples' own positions."""
    tree, _, tmeta = scene()
    tmeta = dataclasses.replace(tmeta, mask_dim=MASK_DIM)
    params = checkpoint.params_from_numpy(tree, "cpu")
    mp = checkpoint.params_from_numpy(jax_mask_params(), "cpu")
    o, d = _rays()
    got = kplane.render_rays(params, tmeta, 0.9, o, d, white_bg=True, transfer_vel=True,
                             mask_params=mp, device="cpu")
    unmoved = kplane.render_rays(params, dataclasses.replace(tmeta, use_vel=False), 0.9, o, d,
                                 white_bg=True, mask_params=mp, device="cpu")
    assert float((got["mask"] - unmoved["mask"]).abs().max()) > 1e-3


def test_bf16_transfer_render_matches_jax():
    """The bf16 arm under transfer (8 RK2 steps back to t = 0), with the
    tolerances of tests/test_torch_bf16.py's render at 11 steps."""
    tree, jmeta, tmeta = test_torch_render._scene()
    jmeta, tmeta = (dataclasses.replace(m, compute_dtype="bfloat16") for m in (jmeta, tmeta))
    o, d = test_torch_render._rays()
    want = _jax_render_fn(jmeta)(_jp(tree), t=jnp.float32(0.6), rays_o=jnp.asarray(o),
                                 rays_d=jnp.asarray(d))
    got = kplane.render_rays(checkpoint.params_from_numpy(tree, "cpu"), tmeta, 0.6, o, d,
                             white_bg=True, transfer_vel=True, device="cpu")
    for k, atol in (("rgb", 5e-6), ("acc", 5e-6), ("depth", 2e-5), ("weight", 1e-5)):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)


def test_render_image_with_mask_params_matches_jax():
    """A 6 x 7 image in chunks of 16 (the last padded), transfer, the
    transfer mask and the head, as test_segm_render renders its views."""
    tree, jmeta, tmeta = scene()
    jmeta, tmeta = (dataclasses.replace(m, mask_dim=MASK_DIM) for m in (jmeta, tmeta))
    state, mp = jax_transfer_mask(), jax_mask_params()
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.2, 0.4, 4.5]
    o, d = rays.ray_bundle(pose, 6, 7, 6.0)
    want = jrender_image(_jp(tree), jmeta, 0.7, o, d, white_bg=True, transfer_vel=True,
                         alpha_state={k: jnp.asarray(v) for k, v in state.items()},
                         mask_params=_jp(mp), chunk=16)
    got = render_image(checkpoint.params_from_numpy(tree, "cpu"), tmeta, 0.7, o, d,
                       white_bg=True, transfer_vel=True,
                       alpha_state=checkpoint.alpha_state_from_numpy(state, "cpu"),
                       mask_params=checkpoint.params_from_numpy(mp, "cpu"), chunk=16,
                       device="cpu")
    assert got["mask"].shape == (6, 7, MASK_DIM)
    for k in ("rgb", "acc", "depth", "mask"):
        rtol, atol = TOL[k]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)
    assert got["acc"].max() > 0.1


@functools.lru_cache(maxsize=None)
def _jax_transfer_alpha_chunk():
    """The transfer body of the JAX package's ``compute_dense_alpha``
    (an inner function there), composed from its public functions."""
    _, jmeta, _ = scene()

    def fn(params, xyz_c, tval):
        t = jnp.full((xyz_c.shape[0], 1), tval, dtype=jnp.float32)
        base = jnp.zeros_like(t)
        prev = jkplane.integrate_pos(params, jmeta, xyz_c, t, base,
                                     n_steps=jmeta.transfer_adv_steps)
        xyzt = jnp.concatenate([prev, jkplane.normalize_time(jmeta, base)], axis=-1)
        sigma = jkplane.feature2density(jmeta, jkplane.density_feature(params, jmeta, xyzt),
                                        {"times": t[..., 0], "time_offset": t[..., 0]})
        return 1.0 - jnp.exp(-sigma * jmeta.step_size)

    return jax.jit(fn)


# t = 0 (no advection), 3 and 5 of the 8 steps (past t = 0.95 the blob has
# left these points)
@pytest.mark.parametrize("tval", [0.0, 0.3, 0.6])
def test_transfer_dense_alpha_chunk_matches_jax(tval):
    tree, jmeta, tmeta = scene()
    x = np.random.RandomState(6).uniform(-0.7, 0.7, (700, 3)).astype(np.float32)
    want = np.asarray(_jax_transfer_alpha_chunk()(_jp(tree), jnp.asarray(x), jnp.float32(tval)))
    got = kplane.dense_alpha_chunk(checkpoint.params_from_numpy(tree, "cpu"), tmeta,
                                   torch.tensor(x), tval, tmeta.transfer_adv_steps,
                                   transfer=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ALPHA_ATOL)
    above = (want > META["alpha_mask_thres"]).mean()
    assert 0.01 < above < 0.95, above


def test_transfer_compute_dense_alpha_matches_jax():
    """Seven times, chunks of 200 (the 693-point grid padded)."""
    tree, jmeta, tmeta = scene()
    want, _ = jkplane.compute_dense_alpha(_jp(tree), jmeta, MASK_GRID, transfer=True, n_times=7,
                                          chunk=200)
    got, _ = kplane.compute_dense_alpha(checkpoint.params_from_numpy(tree, "cpu"), tmeta,
                                        MASK_GRID, transfer=True, n_times=7, chunk=200,
                                        device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=ALPHA_ATOL)
    plain, _ = kplane.compute_dense_alpha(checkpoint.params_from_numpy(tree, "cpu"), tmeta,
                                          MASK_GRID, n_times=7, chunk=200, device="cpu")
    assert float((plain - got).abs().max()) > 1e-3  # the transfer sweep is another one


def test_transfer_mask_flips_no_voxel_against_jax():
    """update_alpha_mask(transfer=True) over the 60 times: the dense alphas
    within tolerance, no alpha nearer alphaMask_thres than the largest gap
    between the two packages' alphas (so rounding cannot flip a voxel), and
    the binary volume equal to JAX's."""
    tree, jmeta, tmeta = scene()
    params = checkpoint.params_from_numpy(tree, "cpu")
    want_alpha, _ = jkplane.compute_dense_alpha(_jp(tree), jmeta, MASK_GRID, transfer=True)
    got_alpha, _ = kplane.compute_dense_alpha(params, tmeta, MASK_GRID, transfer=True,
                                              device="cpu")
    want_alpha = np.asarray(want_alpha)
    np.testing.assert_allclose(got_alpha.numpy(), want_alpha, rtol=1e-4, atol=ALPHA_ATOL)
    margin = np.abs(want_alpha - META["alpha_mask_thres"]).min()
    gap = np.abs(got_alpha.numpy() - want_alpha).max()
    assert margin > gap, (f"an alpha lies {margin:.2e} from the threshold, within the "
                          f"packages' rounding gap {gap:.2e}: a flip there is no fault")
    state, _ = kplane.update_alpha_mask(params, tmeta, MASK_GRID, transfer=True, device="cpu")
    want = jax_transfer_mask()
    flipped = int((state["volume"].numpy() != want["volume"]).sum())
    assert flipped == 0, f"{flipped} voxels flipped"
    np.testing.assert_array_equal(state["dilated"].numpy(), want["dilated"])
    assert 0.05 < want["volume"].mean() < 0.95


@pytest.mark.parametrize("shape", [(3, 37, 53), (1, 1, 5000), (16, 64, 64)])
def test_gif_reads_back_with_pillow(tmp_path, shape):
    """The port's GIF writer (the time sweeps): every frame decodes to its
    quantization, through table resets (5000 random pixels) and several
    frames; Pillow is a test-only reader."""
    from PIL import Image

    rng = np.random.RandomState(sum(shape))
    frames = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    if shape[0] == 16:  # smooth frames, as a render gives
        frames = np.repeat(np.repeat(frames[:, ::8, ::8], 8, 1), 8, 2)
    path = str(tmp_path / "a.gif")
    gif.write_gif(path, frames)
    want = gif.palette()[gif.quantize(frames)]
    im = Image.open(path)
    assert im.n_frames == shape[0] and im.info.get("loop") == 0
    for i in range(shape[0]):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want[i])
    assert np.abs(want.astype(int) - frames).max() <= 43  # half a blue level
