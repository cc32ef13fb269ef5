"""Forward, occupancy-backward and fused lattice recursion: wrappers of the
CUDA kernels in ``csrc/wavefront.cu`` and ``csrc/wavefront_fused.cu`` and
their plain PyTorch versions.

Replaces the Pallas kernels ``fast_rnnt_tpu/ops/kernels/wavefront.py``
``_fwd_kernel`` (:224, entry ``forward_rows_pallas`` :366),
``_bwd_kernel`` (:420, entry ``backward_rows_pallas`` :558) and
``_fused_kernel`` (:623, entry ``fused_rows_pallas`` :799).

A CPU tensor runs the plain version (``recursion._forward_rows_plain`` /
``_backward_rows_plain``); a CUDA tensor launches the kernel or raises.

Dtypes on a CUDA tensor: px/py are float32, bfloat16 or float16 storage
(both the same); the kernels compute in float32, p, ans_grad and the
scores are float32, and the occupancies come back in the storage dtype.
Any other dtype (float64 among them) raises TypeError: it is never sent
to the plain path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..recursion import _backward_rows_plain, _forward_rows_plain
from . import _build

__all__ = [
    "forward_rows",
    "backward_rows",
    "fused_rows",
    "forward_rows_plain",
    "backward_rows_plain",
    "fused_rows_plain",
    "LAUNCHES",
]

LAUNCHES = {"fwd": 0, "bwd": 0, "fused": 0}

forward_rows_plain = _forward_rows_plain
backward_rows_plain = _backward_rows_plain

_MAX_SMEM = 232_448  # bytes of shared memory one Hopper block may use
# storage dtype -> the kernels' StorageCode (csrc/wavefront_rows.cuh)
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _threads(width: int) -> int:
    """One block per utterance; up to 1024 threads, one per lattice column
    when the row fits (each thread scans a segment of ceil(W / threads))."""
    return min(1024, max(32, -(-width // 32) * 32))


def _check_cuda(px_rows, py_rows, boundary, lo, extra=()):
    """Device, dtype, shape and contiguity checks; returns (S, B, T', T,
    threads, storage code).  ``extra`` tensors must be float32."""
    S, B, T1 = px_rows.shape
    if py_rows.dim() != 3 or py_rows.shape[:2] != (S + 1, B):
        raise ValueError(f"py_rows {tuple(py_rows.shape)} != ({S + 1}, {B}, T)")
    T = py_rows.shape[2]
    if T1 not in (T, T + 1):
        raise ValueError(f"px_rows last dim {T1} must be T={T} or T+1={T + 1}")
    if px_rows.dtype not in _STORAGE or py_rows.dtype != px_rows.dtype:
        raise TypeError(
            "the CUDA kernels take px/py of one storage dtype, float32, bfloat16 "
            f"or float16: got {px_rows.dtype} / {py_rows.dtype}"
        )
    dev = px_rows.device
    for name, x in (("px_rows", px_rows), ("py_rows", py_rows), *extra):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {x.device}")
        if name not in ("px_rows", "py_rows") and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ints = [("boundary", boundary, (B, 4))]
    if lo is not None:
        ints.append(("lo", lo, (B, T)))
    for name, x, shape in ints:
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
    nt = _threads(T + 1)
    smem = (4 * (T + 1) + nt) * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"T={T} needs {smem} B of shared memory (> {_MAX_SMEM})")
    return S, B, T1, T, nt, _STORAGE[px_rows.dtype]


def forward_rows(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward lattice, s-major: returns (p_rows [S+1, B, T+1] float32,
    scores [B] float32).  ``px_rows``/``py_rows`` are unmasked; the boundary
    and the optional band ``lo <= s < lo + K`` are masked inside."""
    if not px_rows.is_cuda:
        return _forward_rows_plain(px_rows, py_rows, boundary, lo, K)
    S, B, T1, T, nt, code = _check_cuda(px_rows, py_rows, boundary, lo)
    p_rows = torch.empty((S + 1, B, T + 1), dtype=torch.float32, device=px_rows.device)
    scores = torch.empty((B,), dtype=torch.float32, device=px_rows.device)
    if B == 0:
        return p_rows, scores
    lib = _build.load_library()
    err = lib.frt_wavefront_fwd(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(boundary),
        _build.ptr(lo), int(K), S, B, T, int(T1 == T),
        _build.ptr(p_rows), _build.ptr(scores), nt, code,
        _build.stream_ptr(px_rows.device),
    )
    _build.check(err, "wavefront_fwd")
    LAUNCHES["fwd"] += 1
    return p_rows, scores


def backward_rows(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    p_rows: torch.Tensor,
    boundary: torch.Tensor,
    ans_grad: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occupancy backward, s-major, seeded with ``ans_grad`` [B] at
    (s_end, t_end).  Returns (px_grad [S, B, T'], py_grad [S+1, B, T]) in
    the storage dtype of px/py."""
    if not px_rows.is_cuda:
        return _backward_rows_plain(px_rows, py_rows, p_rows, boundary, ans_grad, lo, K)
    S, B, T1, T, nt, code = _check_cuda(
        px_rows, py_rows, boundary, lo,
        extra=(("p_rows", p_rows), ("ans_grad", ans_grad)),
    )
    W = T + 1
    if tuple(p_rows.shape) != (S + 1, B, W) or tuple(ans_grad.shape) != (B,):
        raise ValueError(
            f"p_rows {tuple(p_rows.shape)} / ans_grad {tuple(ans_grad.shape)} "
            f"!= ({S + 1}, {B}, {W}) / ({B},)"
        )
    px_grad = torch.empty_like(px_rows)
    py_grad = torch.empty_like(py_rows)
    if B == 0:
        return px_grad, py_grad
    lib = _build.load_library()
    err = lib.frt_wavefront_bwd(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(p_rows),
        _build.ptr(boundary), _build.ptr(lo), int(K), _build.ptr(ans_grad),
        S, B, T, int(T1 == T), _build.ptr(px_grad), _build.ptr(py_grad), nt, code,
        _build.stream_ptr(px_rows.device),
    )
    _build.check(err, "wavefront_bwd")
    LAUNCHES["bwd"] += 1
    return px_grad, py_grad


def fused_rows_plain(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the fused kernel: the plain forward, then the
    plain occupancy backward seeded with ones."""
    p_rows, scores = _forward_rows_plain(px_rows, py_rows, boundary, lo, K)
    ones = torch.ones_like(scores)
    px_grad, py_grad = _backward_rows_plain(px_rows, py_rows, p_rows, boundary, ones, lo, K)
    return scores, px_grad, py_grad


def fused_rows(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward and occupancy backward (seed 1) in one launch, s-major:
    returns (scores [B] float32, px_grad [S, B, T'], py_grad [S+1, B, T])
    as :func:`forward_rows` then :func:`backward_rows` with ``ans_grad = 1``
    do.  p goes to a float32 scratch tensor that is not returned; the
    kernel takes every shape the split kernels take and raises past their
    shared-memory limit, as they do."""
    if not px_rows.is_cuda:
        return fused_rows_plain(px_rows, py_rows, boundary, lo, K)
    S, B, T1, T, nt, code = _check_cuda(px_rows, py_rows, boundary, lo)
    dev = px_rows.device
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    px_grad = torch.empty_like(px_rows)
    py_grad = torch.empty_like(py_rows)
    if B == 0:
        return scores, px_grad, py_grad
    p_scratch = torch.empty((S + 1, B, T + 1), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = lib.frt_wavefront_fused(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(boundary),
        _build.ptr(lo), int(K), S, B, T, int(T1 == T),
        _build.ptr(p_scratch), _build.ptr(scores), _build.ptr(px_grad),
        _build.ptr(py_grad), nt, code, _build.stream_ptr(dev),
    )
    _build.check(err, "wavefront_fused")
    LAUNCHES["fused"] += 1
    return scores, px_grad, py_grad
