"""Build and load the port's CUDA kernels (``nvfi_torch/csrc/*.cu``).

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with ``ctypes`` — seconds to build, where a source that includes
PyTorch's headers takes minutes.  Each source compiles to its own object, all
``nvcc`` processes started together, then one link.  The library lands in
``build/nvfi_torch_kernels/`` of the checkout, named by a hash of the sources
and flags, and is built at first use: importing this module builds nothing.

The wrappers (``ops.grid_sample.plane_product``, ``plane_product_density`` and
``plane_product_backward``, ``ops.plane_line.plane_line``,
``plane_line_density`` and ``plane_line_backward``,
``ops.compositing.composite`` and
``composite_backward``, ``ops.occupancy.occupancy_trilinear`` and
``occupancy_nearest``, ``ops.gather.row_gather``) pass pointers from
``Tensor.data_ptr()`` and the current stream; each C function returns ``cudaGetLastError()`` and :func:`check` raises on non-zero.
``csrc/floor.cu`` holds no kernel of a path: its empty and touch kernels
measure the launch floor (``chip_smoke.py``, phase ``floor``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nvfi_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_F3 = ctypes.POINTER(ctypes.c_float)
# volume, D H W, xyz, P, a0[3], asize[3], mask_aabb, renorm, out, stream
_OCCUPANCY = [_P] + [ctypes.c_int] * 3 + [_P, ctypes.c_int64, _F3, _F3, _P, ctypes.c_int, _P, _P]
# K3 reads the volume's cell bits after D H W; K4 reads only the occupied bits,
# in the volume's place
_OCCUPANCY_BITS = _OCCUPANCY[:4] + [_P] + _OCCUPANCY[4:]
_SIGNATURES = {
    # s0 s1 s2 t0 t1 t2, hw[12], xyzt, P, C, Cd, vec, run, smem_bytes, bf16 (the arm: 0
    # float32, 1 bfloat16), density, app, stream
    "nvfi_plane_product_fwd": [_P] * 6 + [ctypes.POINTER(ctypes.c_int), _P, ctypes.c_int64]
                              + [ctypes.c_int] * 6 + [_P, _P, _P],
    # s0 s1 s2 t0 t1 t2, hw[12], xyzt, P, C, Cd, vec, run, smem_bytes, bf16, density, stream
    "nvfi_plane_product_density_fwd": [_P] * 6 + [ctypes.POINTER(ctypes.c_int), _P,
                                                  ctypes.c_int64] + [ctypes.c_int] * 6 + [_P, _P],
    # s0 s1 s2 t0 t1 t2, hw[12], xyzt, P, C, Cd, vec, run, smem_bytes, bf16, g_density,
    # g_app, plane_grads[6] (host array of device pointers, or null), g_xyzt, stats, stream
    "nvfi_plane_product_bwd": [_P] * 6 + [ctypes.POINTER(ctypes.c_int), _P, ctypes.c_int64]
                              + [ctypes.c_int] * 6 + [_P, _P, ctypes.POINTER(_P), _P, _P, _P],
    # ptrs[12] (host array of device pointers: density planes, density lines, app planes,
    # app lines; null where absent), dims[9] (plane H[3], W[3], line L[3]), xyz, P, Cd,
    # Ca, vec, run, smem_bytes, cp, density_only, density, app, stream
    "nvfi_plane_line_fwd": [ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int), _P,
                            ctypes.c_int64] + [ctypes.c_int] * 7 + [_P, _P, _P],
    # ptrs[12], grads[12] (the same layout, zeroed), dims[9], xyz, P, Cd, Ca, vec, run,
    # chunk, d_chunks, a_chunks, smem_bytes, cp, g_density, g_app, stream
    "nvfi_plane_line_bwd": [ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int),
                            _P, ctypes.c_int64] + [ctypes.c_int] * 9 + [_P, _P, _P],
    "nvfi_occupancy_trilinear_fwd": _OCCUPANCY_BITS,
    "nvfi_occupancy_nearest_fwd": _OCCUPANCY,
    # tab, idx, n, C, out, stream
    "nvfi_row_gather_fwd": [_P, _P, ctypes.c_int64, ctypes.c_int, _P, _P],
    # the launch floor (csrc/floor.cu): blocks, threads, stream; xyz, P, out, stream
    "nvfi_floor_empty": [ctypes.c_int, ctypes.c_int, _P],
    "nvfi_floor_touch": [_P, ctypes.c_int64, _P, _P],
    # sigma dist z rgb_pts, N, S, warps_per_ray, tiles_per_warp, rays_per_block, thres,
    # white_bg, far, weight acc rgb depth rgb_raw, stream
    "nvfi_composite_fwd": [_P] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 4
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [_P] * 6,
    # sigma dist z rgb_pts weight rgb_raw, g_rgb g_acc g_depth g_weight, N, S,
    # warps_per_ray, tiles_per_warp, rays_per_block, thres, white_bg, far, grad_sigma
    # grad_rgb_pts, stream
    "nvfi_composite_bwd": [_P] * 10 + [ctypes.c_int64] + [ctypes.c_int] * 4
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_float] + [_P] * 3,
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvfi_torch: nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnvfi_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict:
    """Compile every source in parallel and link the library (if missing).

    Returns ``{"path", "seconds", "log", "cached"}``; ``log`` holds the
    ``-Xptxas -v`` register and spill report when ``verbose``.
    """
    path = library_path()
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "log": "", "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = path.parent / f"{path.name}.{tag}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, path)
    return {"path": str(path), "seconds": time.perf_counter() - t0,
            "log": "\n".join(logs), "cached": False}


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nvfi_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nvfi_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = load().nvfi_cuda_error_string(err).decode()
        raise RuntimeError(f"nvfi_torch kernel {name}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
