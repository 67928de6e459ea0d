"""The port's host samplers and ray helpers (``nvfi_torch.data.sampler``,
``nvfi_torch.render.rays``) held against the JAX package's bit for bit: the
same numpy generators and seeds give the same ids, probabilities, poses and
rays."""

import numpy as np
import pytest

from nvfi_tpu.data import sampler as jsampler
from nvfi_tpu.render import rays as jrays
from nvfi_torch.data import PatchSampler, RayImportanceSampler, SimpleSampler
from nvfi_torch.render import rays


@pytest.mark.parametrize("total,batch", [(100, 32), (96, 32), (10, 10)])
def test_simple_sampler_matches_jax_across_reshuffles(total, batch):
    """Seven batches: the permutation is redrawn where a batch would run past
    the end (100 / 32: after three batches, 96 / 32: after two, 10 / 10: every
    batch)."""
    got, want = SimpleSampler(total, batch, seed=3), jsampler.SimpleSampler(total, batch, seed=3)
    seen = set()
    for _ in range(7):
        ids = got.nextids()
        np.testing.assert_array_equal(ids, want.nextids())
        assert len(ids) == batch and len(set(ids.tolist())) == batch
        seen.add(tuple(got.ids.tolist()))
    assert len(seen) > 1  # at least one reshuffle happened


def test_ray_importance_sampler_matches_jax():
    rng = np.random.RandomState(0)
    rgbs = rng.uniform(0, 1, (5, 12 * 10, 3)).astype(np.float32)
    rgbs[:, :40] = 0.5  # pixels equal to their median: weight 0, never drawn
    got = RayImportanceSampler(rgbs, 64, n_images=5, alpha=0.1, seed=7)
    want = jsampler.RayImportanceSampler(rgbs, 64, n_images=5, alpha=0.1, seed=7)
    np.testing.assert_array_equal(got.probs, want.probs)
    assert got.total == want.total == 5 * 120
    for _ in range(4):
        ids = got.nextids()
        np.testing.assert_array_equal(ids, want.nextids())
        assert not np.isin(ids % 120, np.arange(40)).any()


def test_patch_sampler_matches_jax():
    got = PatchSampler(radius_range=(3.0, 4.0), phi_range=(-40.0, -10.0), seed=5)
    want = jsampler.PatchSampler(radius_range=(3.0, 4.0), phi_range=(-40.0, -10.0), seed=5)
    for _ in range(5):
        pose = got.next_pose()
        np.testing.assert_array_equal(pose, want.next_pose())
        assert pose.shape == (4, 4) and 3.0 <= np.linalg.norm(pose[:3, 3]) <= 4.0


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(np.random.RandomState(1).randn(3, 3))[0]
    pose[:3, 3] = [0.3, -0.2, 3.9]
    return pose


def test_sample_pixels_and_camera_rays_match_jax():
    H, W, focal = 12, 10, 9.5
    got = rays.sample_pixels(np.random.default_rng(4), H, W, 50)
    want = jrays.sample_pixels(np.random.default_rng(4), H, W, 50)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(set(zip(*map(np.ndarray.tolist, got)))) == 50  # distinct pixels

    target = np.random.RandomState(2).uniform(0, 1, (H, W, 3)).astype(np.float32)
    for tgt in (target, None):
        cam = rays.Camera(_pose(), H, W, focal, target=tgt, near=2.0, far=6.0)
        jcam = jrays.Camera(_pose(), H, W, focal, target=tgt, near=2.0, far=6.0)
        np.testing.assert_array_equal(cam.rays_o, jcam.rays_o)
        np.testing.assert_array_equal(cam.rays_d, jcam.rays_d)
        g_rng, w_rng = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(3):  # the generator's state carries across calls
            for g, w in zip(cam.sample_rays(g_rng, 17), jcam.sample_rays(w_rng, 17)):
                if w is None:
                    assert g is None
                else:
                    np.testing.assert_array_equal(g, w)


def test_batched_rays_match_jax():
    H, W, focal = 6, 8, 7.0
    rng = np.random.RandomState(3)
    targets = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
    poses = np.stack([_pose(), np.eye(4, dtype=np.float32), _pose() * 0.5])
    times = np.array([0.0, 0.25, 0.6], np.float32)
    got = rays.batched_rays(targets, poses, times, H, W, focal)
    want = jrays.batched_rays(targets, poses, times, H, W, focal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (3 * H * W, 3) and (got[3][H * W:2 * H * W] == 0.25).all()


@pytest.mark.parametrize("call", ["ray_bundle", "camera", "batched_rays"])
def test_ndc_rays_are_refused_naming_a3(call):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
        if call == "ray_bundle":
            rays.ray_bundle(_pose(), 4, 4, 3.0, ndc=True)
        elif call == "camera":
            rays.Camera(_pose(), 4, 4, 3.0, ndc=True)
        else:
            rays.batched_rays(np.zeros((1, 4, 4, 3)), [_pose()], [0.0], 4, 4, 3.0, ndc=True)
