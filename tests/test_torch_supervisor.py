"""The port's supervisor (``nvfi_torch.train.supervisor``) and the training CLI's
``--supervise`` / ``--profile`` flags on the CPU.

The supervisor cases are ``tests/test_supervisor.py``'s on the port's copy,
with fake children and short timeouts: a stall is killed and resumed, a
crash restarts until ``max_restarts`` gives up, a clean exit ends it.  Then
the CLI: ``--supervise`` re-runs the command as ``python -u -m
nvfi_torch.train_nvfi`` (with ``--resume --logdir`` from attempt 1 on) and
touches no device in the parent; a real supervised run of a tiny scene
finishes in one attempt; ``--profile 2`` writes a Chrome trace."""

import json
import os
import sys
import textwrap
import time

import pytest
import torch

from nvfi_torch import train_nvfi
from nvfi_torch.train import supervisor
from nvfi_torch.train.supervisor import run_supervised, touch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synth", "bat.yaml")
TINY = ["--synthetic", "--synth_res", "16", "--synth_frames", "6", "--device", "cpu",
        "nvfi.N_voxel_init", "4096", "nvfi.N_voxel_final", "4096", "nvfi.upsamp_list", "[]",
        "nvfi.update_AlphaMask_list", "[]", "nvfi.density_n_comp", "[4,4,4]",
        "nvfi.appearance_n_comp", "[4,4,4]", "nvfi.app_dim", "8", "nvfi.featureC", "16",
        "nvfi.vel_hidden", "16", "renderer.n_rays", "32", "nvfi.max_n_samples", "16",
        "experiment.vel_reg_n_pts", "64", "experiment.train_iters", "3",
        "experiment.multi_frame_batch", "true"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_child(tmp_path, body: str) -> str:
    p = tmp_path / "child.py"
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_stall_is_killed_and_resumed(tmp_path):
    hb = str(tmp_path / "heartbeat")
    marker = str(tmp_path / "first_attempt_done")
    child = _write_child(tmp_path, f"""
        import os, sys, time
        hb, marker = {hb!r}, {marker!r}
        def touch(p):
            open(p, 'a').close(); os.utime(p, None)
        if not os.path.exists(marker):
            # attempt 0: one heartbeat, then alive without progress
            touch(marker); touch(hb)
            time.sleep(600)
            sys.exit(7)  # never reached: the supervisor ends the group
        # attempt 1, "resumed from the checkpoint": finishes cleanly
        assert '--resume' in sys.argv, sys.argv
        touch(hb)
        sys.exit(0)
    """)
    calls = []

    def build_argv(attempt):
        calls.append(attempt)
        return [sys.executable, child] + (["--resume"] if attempt else [])

    t0 = time.time()
    rc, restarts = run_supervised(build_argv, hb, stall_timeout=1.0, poll=0.1, grace=1.0,
                                  max_restarts=3, log=lambda *_: None)
    assert (rc, restarts, calls) == (0, 1, [0, 1])
    assert time.time() - t0 < 30  # the 600 s wedge was ended


def test_crash_restarts_and_gives_up_at_cap(tmp_path):
    hb = str(tmp_path / "heartbeat")
    touch(hb)
    child = _write_child(tmp_path, """
        import sys
        sys.exit(3)  # crashes every attempt
    """)
    logs = []
    rc, restarts = run_supervised(lambda attempt: [sys.executable, child], hb,
                                  stall_timeout=30.0, poll=0.1, max_restarts=2, log=logs.append)
    assert (rc, restarts) == (3, 2)
    assert sum("attempt" in line for line in logs) == 3 and "giving up" in logs[-1]


def test_clean_exit_no_restart(tmp_path):
    child = _write_child(tmp_path, """
        import sys
        sys.exit(0)
    """)
    rc, restarts = run_supervised(lambda attempt: [sys.executable, child],
                                  str(tmp_path / "heartbeat"), stall_timeout=30.0, poll=0.1,
                                  log=lambda *_: None)
    assert (rc, restarts) == (0, 0)


def test_touch_creates_and_refreshes(tmp_path):
    hb = str(tmp_path / "heartbeat")
    touch(hb)
    os.utime(hb, (1.0, 1.0))
    touch(hb)
    assert os.path.getmtime(hb) > 1e9


def test_supervise_reexecs_the_module_and_resumes(tmp_path, monkeypatch):
    """The child is ``python -u -m nvfi_torch.train_nvfi`` with the same
    arguments minus ``--supervise``; from attempt 1 on it resumes in the
    logdir; the parent resolves no device."""
    seen = {}

    def fake_run(build_argv, heartbeat_path, stall_timeout, **_):
        seen.update(argvs=[build_argv(a) for a in range(3)], hb=heartbeat_path,
                    stall=stall_timeout)
        return 0, 2

    def no_device(*_):
        raise AssertionError("the supervising parent resolved a device")

    monkeypatch.setattr(supervisor, "run_supervised", fake_run)
    monkeypatch.setattr("nvfi_torch.device.resolve_device", no_device)
    logdir = str(tmp_path / "run")
    args = ["--config", CONFIG, "--static_dynamic", "--supervise", "--stall_timeout", "42",
            "--logdir", logdir, "--profile", "2", "experiment.train_iters", "3"]
    out = train_nvfi.main(args)
    assert out == {"rc": 0, "restarts": 2}
    base = [sys.executable, "-u", "-m", "nvfi_torch.train_nvfi"] + [
        a for a in args if a != "--supervise"]
    assert seen["argvs"] == [base, base + ["--resume", "--logdir", logdir],
                             base + ["--resume", "--logdir", logdir]]
    assert seen["hb"] == os.path.join(logdir, "heartbeat") and seen["stall"] == 42.0
    assert os.path.exists(os.path.join(logdir, "config.yaml"))
    # a command that resumes already is re-run as it is
    resumed = train_nvfi.supervised_argv(["--resume", "--logdir", logdir], logdir)
    assert resumed(1) == resumed(0) == [sys.executable, "-u", "-m", "nvfi_torch.train_nvfi",
                                        "--resume", "--logdir", logdir]


def test_supervised_tiny_run_finishes_in_one_attempt(tmp_path, monkeypatch):
    """A real supervised child: the port's training CLI on a tiny multi-frame
    scene, on the CPU, run from the repository root."""
    monkeypatch.chdir(REPO)
    logdir = str(tmp_path / "run")
    out = train_nvfi.main(["--config", CONFIG, "--static_dynamic", "--supervise",
                           "--logdir", logdir, *TINY])
    assert out == {"rc": 0, "restarts": 0}
    names = set(os.listdir(logdir))
    assert {"heartbeat", "metrics.jsonl", "model_00002.npz"} <= names


def test_profile_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "run")
    out = train_nvfi.main(["--config", CONFIG, "--static_dynamic", "--profile", "2",
                           "--logdir", logdir, *TINY])
    assert out["trainer"].global_step == 3
    traces = os.listdir(os.path.join(logdir, "profile"))
    assert traces == ["trace_00000.json"]
    with open(os.path.join(logdir, "profile", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the two traced steps' host ops, the rendering's among them
    assert len(events) > 100 and any("aten::" in n for n in names)
