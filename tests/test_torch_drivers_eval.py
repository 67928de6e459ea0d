"""The port's scoring scripts (``python -m nvfi_torch.render_video`` and
``python -m nvfi_torch.eval_all``) held against the JAX package's
(``render_video.py``, ``scripts/eval_all.py``, run with ``sys.argv`` set) on
one checkpoint on the CPU.

The scene directory holds a checkpoint that the JAX package wrote of
``test_torch_occupancy``'s seeded scene (a density blob, a velocity net
scaled up so that advection moves points; grid (12, 10, 9), K = 4, tmax
0.75) and a ``config.yaml`` (bat's), which the port's scripts take by
default.  The video's frames span t in [0, 1], past tmax; every PNG must be
within 1 level of JAX's.  ``eval_all``'s PSNRs must be within 1e-3 dB (JAX's
unrounded values are recorded from its ``psnr``), its velocity and advection
numbers within rtol 1e-5, and its lines the same but for the numbers.
"""

import ast
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch
import jax

import nvfi_tpu.eval.metrics as jmetrics
from nvfi_tpu.train import checkpoint as jcheckpoint
from nvfi_torch import eval_all, render_video
from nvfi_torch.config import load_config
from nvfi_torch.utils.png import read_png

from test_torch_occupancy import scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO = ["--synth_res", "24", "--n_frames", "4", "--alpha_grid", "16", "--depth"]
EVAL = ["--res", "16", "--frames", "6", "--alpha_grid", "16"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_script(name, path):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    tree, jmeta, _ = scene()
    jcheckpoint.save(str(d / "model_00005"), jax.tree.map(np.asarray, tree), jmeta,
                     extra={"global_step": 6})
    cfg = load_config(os.path.join(REPO, "configs", "synth", "bat.yaml"))
    (d / "config.yaml").write_text(cfg.dump())
    return str(d)


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", argv)
    module.main()


def test_render_video_matches_jax(scene_dir, tmp_path, monkeypatch):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_jax(_jax_script("render_video", "render_video.py"),
             ["render_video.py", "--config", os.path.join(scene_dir, "config.yaml"),
              "--scene_dir", scene_dir, "--outdir", jdir, *VIDEO], monkeypatch)
    out = render_video.main(["--scene_dir", scene_dir, "--outdir", tdir, "--device", "cpu",
                             *VIDEO])
    assert out["frames"].shape == (4, 24, 24, 3) and out["times"][-1] == 1.0
    assert out["meta"].block_budget == 1.0 and out["meta"].shade_fraction == 1.0
    for kind in ("r", "d"):
        for i in range(4):
            want = read_png(os.path.join(jdir, f"{kind}_{i:03d}.png")).astype(np.int16)
            got = read_png(os.path.join(tdir, f"{kind}_{i:03d}.png")).astype(np.int16)
            assert got.shape == want.shape == (24, 24, 3)
            assert np.abs(got - want).max() <= 1, (kind, i, int(np.abs(got - want).max()))
            if kind == "r":
                np.testing.assert_array_equal(got, out["frames"][i])
                # the blob is in view, in front of the white background
                assert (got < 200).any(-1).sum() >= 10, i
    with open(os.path.join(tdir, "video.gif"), "rb") as f:
        assert f.read(6) == b"GIF89a"


def _numbers(line):
    """The dict printed after the tag of a line of eval_all."""
    return ast.literal_eval(line[line.index("{"):])


def test_eval_all_matches_jax(scene_dir, monkeypatch, capsys):
    recorded, psnr = [], jmetrics.psnr
    monkeypatch.setattr(jmetrics, "psnr", lambda a, b: recorded.append(psnr(a, b)) or
                        recorded[-1])
    _run_jax(_jax_script("eval_all", os.path.join("scripts", "eval_all.py")),
             ["eval_all.py", "--scene_dir", scene_dir, *EVAL], monkeypatch)
    want_lines = capsys.readouterr().out.strip().splitlines()
    out = eval_all.main(["--scene_dir", scene_dir, "--device", "cpu", *EVAL])
    got_lines = capsys.readouterr().out.strip().splitlines()

    def shape(lines):
        return [re.sub(r"-?\d+\.\d+(e-?\d+)?", "#", line) for line in lines]

    assert shape(got_lines) == shape(want_lines)
    assert len(want_lines) == 16 and len(out["psnr"]) == 8
    # JAX's psnr calls: the split's aggregate in render_split, then one a view
    assert len(recorded) == 9
    aggregate, recorded = recorded[0], recorded[1:]
    np.testing.assert_allclose(out["psnr"], recorded, rtol=0, atol=1e-3)
    tmax = 0.75
    np.testing.assert_allclose(
        [out["interp"], out["extrap"]],
        [np.mean([p for p, t in zip(recorded, out["times"]) if t <= tmax]),
         np.mean([p for p, t in zip(recorded, out["times"]) if t > tmax])], rtol=0, atol=1e-3)
    want_errors = _numbers(next(x for x in want_lines if x.startswith("[test] aggregate")))
    assert want_errors["psnr"] == aggregate and 5.0 < aggregate < 40.0
    np.testing.assert_allclose(out["errors"]["psnr"], aggregate, rtol=0, atol=1e-3)
    for t in eval_all.VELOCITY_TIMES:
        want = _numbers(next(x for x in want_lines if x.startswith(f"[velocity t={t}]")))
        assert sorted(out["velocity"][t]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(out["velocity"][t][k], w, rtol=1e-5, err_msg=(t, k))
        assert want["epe_moving"] > 0
    want = _numbers(next(x for x in want_lines if x.startswith("[advection")))
    for k, w in want.items():
        np.testing.assert_allclose(out["advection"][k], w, rtol=1e-5, err_msg=k)
    assert want["displacement_mean"] > 0
