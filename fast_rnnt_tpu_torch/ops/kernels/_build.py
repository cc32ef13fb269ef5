"""Build and load the CUDA kernels of ``fast_rnnt_tpu_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` (one process per
source, all started together) and links them into one shared library
with a plain C interface, for Hopper (``sm_90a``), into
``build/kernels/`` at the root of the checkout.  The file name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  The library is loaded with ``ctypes``:
every pointer and the stream are ``c_void_p``, every size ``c_int``, and
every entry returns ``cudaGetLastError()`` after its launch.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_library", "check", "stream_ptr", "ptr", "BUILD_LOG"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

P, I = ctypes.c_void_p, ctypes.c_int
# argtypes of every C entry (see the .cu files for the argument meanings)
_SIGNATURES = {
    # px, py, boundary, lo, K, S, B, T, modified, p, scores, threads, dtype,
    # strips at once (nk), their counters (ctr), stream
    "frt_sweep_fwd": [P, P, P, P, I, I, I, I, I, P, P, I, I, I, P, P],
    # px, py, p, boundary, lo, K, ans_grad, S, B, T, modified, hand-off rows,
    # pxg, pyg, threads, dtype, nk, ctr, stream
    "frt_sweep_bwd": [P, P, P, P, P, I, P, I, I, I, I, P, P, P, I, I, I, P, P],
    # device: the sweep kernels' blocks the device holds at once
    "frt_sweep_resident": [I],
    # the row scans: frt_scan_fwd as frt_sweep_fwd and frt_scan_bwd as
    # frt_sweep_bwd, without the hand-off rows, nk and ctr
    "frt_scan_fwd": [P, P, P, P, I, I, I, I, I, P, P, I, I, P],
    "frt_scan_bwd": [P, P, P, P, P, I, P, I, I, I, I, P, P, I, I, P],
    # px, py, boundary, lo, K, S, B, T, modified, p (scratch, S+1+strips
    # rows), scores, pxg, pyg, threads, dtype, nk, ctr, stream
    "frt_wavefront_fused": [P, P, P, P, I, I, I, I, I, P, P, P, P, I, I, I, P, P],
    # lm, symbols, te, am, uni, B, S, T, C, blank, modified, bf16, prec,
    # side, img_hi, img_lo, px, py, nd, d, amax, duni, stream
    "frt_latbuild_fwd": [P] * 5 + [I] * 8 + [P] * 10,
    # lmp, symbols, te, am, amax, d, duni, dpx, dpy, dnd, B, S, T, C, blank,
    # modified, bf16, prec, wT, wimg_hi, wimg_lo, limg_hi, limg_lo, colsum,
    # rsx, rsy, rd, d_am, d_lm, duni_part, stream
    "frt_latbuild_bwd": [P] * 10 + [I] * 8 + [P] * 13,
    # B, S, T, C, bf16, smoothed, prec, out (int64[5])
    "frt_latbuild_sizes": [I] * 7 + [P],
    # x, m, rows, cols, prec, out, stream: the forward's rounded exps
    "frt_round_exps": [P, P, ctypes.c_longlong, I, I, P, P],
    # gy, gx, boundary, S1, B, T, T1x, K, adjust_step, raw (scratch), out,
    # threads, dtype, stream
    "frt_ranges": [P, P, P, I, I, I, I, I, I, P, P, I, I, P],
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = {}  # seconds, path and compiler output of this process's build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Return the loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        import time

        sources = sorted(CSRC.glob("*.cu"))
        out = BUILD_DIR / f"libfrt_kernels_{_source_hash()}.so"
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{os.getpid()}.tmp"
            nvcc = _nvcc()
            # one nvcc per source, all started together, then one link
            objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for src, obj in zip(sources, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            failed = [(s.name, p.returncode, lg) for s, p, lg in zip(sources, procs, logs)
                      if p.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n} ({rc}):\n{lg}" for n, rc, lg in failed))
            tmp = out.with_suffix(f".{tag}")
            res = subprocess.run(
                [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            for obj in objs:
                obj.unlink(missing_ok=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
            BUILD_LOG["compiler_output"] = "".join(logs) + res.stdout + res.stderr
        BUILD_LOG["seconds"] = time.perf_counter() - t0
        BUILD_LOG["path"] = str(out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.frt_error_string.argtypes = [ctypes.c_int]
        lib.frt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = _lib.frt_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t):
    """Device pointer of a tensor, or None (a NULL pointer) for None.  A
    tensor without storage of its own raises TypeError: a ``DTensor``
    (whose ``data_ptr()`` is 0) reaches a kernel only shard by shard,
    through the partitioned wrappers of ``kernels/partition.py``."""
    if t is None:
        return None
    from .partition import _is_dtensor

    if _is_dtensor(t) or (t.numel() and not t.data_ptr()):
        raise TypeError(
            f"a {type(t).__name__} without storage of its own reached a CUDA kernel: pass "
            "DTensors to the losses, the ops or the kernel wrappers, which run the kernels "
            "on each shard's local tensor"
        )
    return t.data_ptr()
