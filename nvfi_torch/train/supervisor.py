"""Training supervision: stall detection and auto-resume.

The port's own copy of ``nvfi_tpu/train/supervisor.py:32-119``.

* The ``Trainer`` heartbeats by device round trip: every few steps it reads a
  scalar back from the card and touches ``<logdir>/heartbeat``, so a fresh
  mtime proves that steps complete on the device, not only that the host
  enqueues them (CUDA launches are asynchronous).
* The supervisor runs the training CLI as a child in a session of its own and
  watches the heartbeat.  A stall or a non-zero exit ends the child's process
  group (SIGTERM, then SIGKILL), and the next attempt resumes from the latest
  checkpoint.
* A clean exit 0 ends supervision; ``max_restarts`` bounds the restarts.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time


def touch(path: str) -> None:
    """Create a heartbeat file or refresh its mtime."""
    with open(path, "a"):
        os.utime(path, None)


def _kill_group(child: subprocess.Popen, grace: float) -> None:
    """Terminate the child's whole process group (it was started with
    ``start_new_session=True``), escalating to SIGKILL after ``grace``."""
    try:
        pgid = os.getpgid(child.pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.time() + grace
    while time.time() < deadline:
        if child.poll() is not None:
            return
        time.sleep(0.2)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def run_supervised(
    build_argv,
    heartbeat_path: str,
    stall_timeout: float = 720.0,
    poll: float = 5.0,
    max_restarts: int = 5,
    grace: float = 10.0,
    log=print,
):
    """Supervise a training command with stall detection and auto-resume.

    Args:
      build_argv: ``attempt -> list[str]``, the command of attempt N.
        Attempt 0 is the first launch; attempts >= 1 must resume from the
        latest checkpoint (the CLI adds ``--resume``).
      heartbeat_path: the file whose mtime proves progress on the device.  A
        missing file counts its age from the attempt's launch, so
        ``stall_timeout`` also covers the start-up (the kernel build).
      stall_timeout: seconds of heartbeat silence that declare a stall.
      max_restarts: restarts allowed before giving up with the last rc.

    Returns:
      (rc, restarts): the last child's exit code (0 on success) and the
      number of restarts.
    """
    restarts = 0
    while True:
        argv = build_argv(restarts)
        launched = time.time()
        log(f"[supervise] attempt {restarts}: {' '.join(map(str, argv))}")
        child = subprocess.Popen(argv, start_new_session=True)
        stalled = False
        while True:
            rc = child.poll()
            if rc is not None:
                break
            try:
                last = os.path.getmtime(heartbeat_path)
            except OSError:
                last = launched
            age = time.time() - max(last, launched)
            if age > stall_timeout:
                stalled = True
                log(f"[supervise] STALL: heartbeat {age:.0f}s old; killing "
                    f"process group of pid {child.pid}")
                _kill_group(child, grace)
                rc = child.wait()
                break
            time.sleep(poll)
        if not stalled and rc == 0:
            log(f"[supervise] clean exit after {restarts} restart(s)")
            return 0, restarts
        restarts += 1
        if restarts > max_restarts:
            log(f"[supervise] giving up after {max_restarts} restarts (rc={rc})")
            return int(rc) if rc else 1, restarts - 1
        log(f"[supervise] child {'stalled' if stalled else f'died rc={rc}'}; "
            f"restart #{restarts} with resume")
