"""Start N ranks, one process each, and collect what they return.

JAX drives N chips from one process; PyTorch runs a process a rank.
:func:`launch` spawns the ranks (``torch.multiprocessing``, start method
``spawn``), joins them in a process group on ``tcp://127.0.0.1:<free port>``
and calls ``fn(mesh, *args)`` in each with its :class:`parallel.mesh.Mesh`:

* ``device="cuda"``: an ``nccl`` group, rank r on ``cuda:r``.  More ranks
  than visible cards are refused: two NCCL ranks never share a card, and no
  rank ever falls back to the CPU.
* ``device="cuda", shared_card=True``: every rank on ``cuda:0`` in a ``gloo``
  group (whose ``all_reduce`` and ``broadcast`` take CUDA tensors).  A test
  facility, as JAX's tests run on virtual CPU devices: it shows that ranks
  agree on one card, not that they scale.
* ``device="cpu"``: a ``gloo`` group on the CPU, ``threads`` torch threads a
  rank (by default the caller's torch threads shared out).

``model_axis`` M > 1 gives every rank the ``('data', 'model')`` mesh of
shape (n / M, M) (``parallel.mesh.make_mesh``).

``fn`` must be a module-level function of ``nvfi_torch``: the children import
its module and nothing else of the caller's (a test module would bring in
JAX).  Each rank's result comes back with the launch counters of its kernel
wrappers (``ops.counters``, counted from 0 in the fresh process); tensors in
a result are turned into numpy arrays on the way.  A rank that raises ends
the others, and :func:`launch` raises with its traceback.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_host(obj):
    """Tensors -> numpy arrays, through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[to_host(v) for v in obj])
    if isinstance(obj, (list, tuple)):
        return type(obj)([to_host(v) for v in obj])
    return obj


def _rank_main(rank, n, port, fn, args, device, shared_card, threads, timeout, model_axis,
               results):
    from ..ops import counters
    from .mesh import make_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        if device == "cpu" or shared_card:
            backend = "gloo"
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        else:
            backend = "nccl"
        dev = (torch.device("cpu") if device == "cpu"
               else torch.device("cuda", 0 if shared_card else rank))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=n, rank=rank, timeout=timedelta(seconds=timeout))
        try:
            mesh = make_mesh(device=dev, model_axis=model_axis)
            counters.reset_counts()
            out = fn(mesh, *args[rank])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            # pickled here, where a failure is the rank's error (the queue's
            # feeder thread would drop it silently)
            message = pickle.dumps((rank, "ok", to_host(out), counters.read_counts()))
        finally:
            dist.destroy_process_group()
    except BaseException:
        message = pickle.dumps((rank, "error", traceback.format_exc(), None))
    results.put(message)


def launch(fn, n: int, args=(), *, rank_args=None, device="cuda", shared_card: bool = False,
           threads: int | None = None, timeout: float = 1800.0, model_axis: int = 1) -> list:
    """``fn(mesh, *args)`` in ``n`` ranks (``rank_args[r]`` in place of
    ``args`` for rank r, if given) on a mesh with ``model_axis``.  Returns,
    by rank, ``{"rank", "result", "launches"}``."""
    if not getattr(fn, "__module__", "").startswith("nvfi_torch."):
        raise ValueError(f"launch: {fn!r} is not a function of nvfi_torch; the ranks import "
                         "only the port")
    if n < 1 or n % model_axis:
        raise ValueError(f"launch: {n} ranks (model axis {model_axis})")
    device = torch.device(device).type
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: device 'cuda' asked but torch.cuda.is_available() is "
                               "False")
        if not shared_card and n > torch.cuda.device_count():
            raise ValueError(f"launch: {n} NCCL ranks need {n} cards, "
                             f"{torch.cuda.device_count()} visible (two NCCL ranks never share "
                             "a card)")
    elif device != "cpu":
        raise ValueError(f"launch: device {device!r}")
    elif shared_card:
        raise ValueError("launch: shared_card is for ranks on one CUDA card")
    if device == "cpu" and threads is None:
        threads = max(1, torch.get_num_threads() // n)  # the ranks share the caller's threads
    per_rank = list(rank_args) if rank_args is not None else [tuple(args)] * n
    if len(per_rank) != n:
        raise ValueError(f"launch: {len(per_rank)} rank_args for {n} ranks")

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, fn, per_rank, device, shared_card, threads, timeout,
                               model_axis, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out = [None] * n
    try:
        deadline = time.monotonic() + timeout
        got = 0
        while got < n:
            try:
                rank, status, payload, launches = pickle.loads(results.get(timeout=1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and out[r] is None]
                if dead:
                    raise RuntimeError(f"launch: rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode}) without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: no result from every rank in {timeout} s")
                continue
            if status != "ok":
                raise RuntimeError(f"launch: rank {rank} of {n} failed:\n{payload}")
            out[rank] = {"rank": rank, "result": payload, "launches": launches}
            got += 1
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return out

