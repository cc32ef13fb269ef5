"""Forward, occupancy-backward and fused lattice recursion: wrappers of the
CUDA kernels in ``csrc/wavefront_fused.cu`` and their plain PyTorch
versions, and of the row-scan pair in ``csrc/wavefront.cu``.

Replaces the Pallas kernels ``fast_rnnt_tpu/ops/kernels/wavefront.py``
``_fwd_kernel`` (:224, entry ``forward_rows_pallas`` :366),
``_bwd_kernel`` (:420, entry ``backward_rows_pallas`` :558) and
``_fused_kernel`` (:623, entry ``fused_rows_pallas`` :799).  All three run
one diagonal-sweep kernel, instantiated on the phases it runs: the
forward alone (:func:`forward_rows`), the backward alone
(:func:`backward_rows`) or both (:func:`fused_rows`); seeded with ones, the
first two give the third's bits.  The row-scan pair
(:func:`forward_rows_scan`, :func:`backward_rows_scan`) is the first port
of the first two; no package path calls it, and it keeps a T cap.

A CPU tensor runs the plain version (``recursion._forward_rows_plain`` /
``_backward_rows_plain``); a CUDA tensor launches the kernel or raises.
``impl="plain"`` (per call, or ``recursion.set_default_impl("plain")``)
sends every tensor to the plain version, and ``"cuda"`` makes a CPU tensor
raise.

Dtypes on a CUDA tensor: px/py are float32, bfloat16 or float16 storage
(both the same); the kernels compute in float32, p, ans_grad and the
scores are float32, and the occupancies come back in the storage dtype.
Any other dtype (float64 among them) raises TypeError: it is never sent
to the plain path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..recursion import _backward_rows_plain, _forward_rows_plain, _kernel_route
from . import _build
from .partition import partitioned

__all__ = [
    "forward_rows",
    "backward_rows",
    "fused_rows",
    "forward_rows_plain",
    "backward_rows_plain",
    "fused_rows_plain",
    "forward_rows_scan",
    "backward_rows_scan",
    "LAUNCHES",
]

# fwd / bwd / fused: the diagonal sweep; scan_fwd / scan_bwd: the row scans
LAUNCHES = {"fwd": 0, "bwd": 0, "fused": 0, "scan_fwd": 0, "scan_bwd": 0}

forward_rows_plain = _forward_rows_plain
backward_rows_plain = _backward_rows_plain

_MAX_SMEM = 232_448  # bytes of shared memory one Hopper block may use
# storage dtype -> the kernels' StorageCode (csrc/wavefront_rows.cuh)
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the sweep kernels' block: one warp sweeps an utterance's diagonals, seven
# move its tiles between device and shared memory
_SWEEP_THREADS = 256


def _threads(width: int) -> int:
    """Row scans: one block per utterance; up to 1024 threads, one per
    lattice column when the row fits (each thread scans a segment of
    ceil(W / threads))."""
    return min(1024, max(32, -(-width // 32) * 32))


def _check_cuda(px_rows, py_rows, boundary, lo, extra=()):
    """Device, dtype, shape and contiguity checks; returns (S, B, T', T,
    storage code).  ``extra`` tensors must be float32."""
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
    return S, B, T1, T, _STORAGE[px_rows.dtype]


def _check_index(S: int, B: int, T: int, rows: int) -> None:
    """The sweep kernels index a (rows, B, T+1) float32 tensor in int32."""
    if rows * B * (T + 1) >= 2**31:
        raise ValueError(f"S={S} B={B} T={T}: a ({rows}, B, T+1) lattice exceeds int32 indexing")


def _check_split(px_rows, py_rows, boundary, lo, extra=()):
    """``_check_cuda`` plus the row scans' shared-memory cap (four
    (T+1)-float rows); returns (S, B, T', T, threads, storage code)."""
    S, B, T1, T, code = _check_cuda(px_rows, py_rows, boundary, lo, extra)
    nt = _threads(T + 1)
    smem = (4 * (T + 1) + nt) * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"T={T} needs {smem} B of shared memory (> {_MAX_SMEM})")
    return S, B, T1, T, nt, code


def _check_p(p_rows, ans_grad, S, B, T):
    if tuple(p_rows.shape) != (S + 1, B, T + 1) or tuple(ans_grad.shape) != (B,):
        raise ValueError(
            f"p_rows {tuple(p_rows.shape)} / ans_grad {tuple(ans_grad.shape)} "
            f"!= ({S + 1}, {B}, {T + 1}) / ({B},)"
        )


@partitioned({"px_rows": 1, "py_rows": 1, "boundary": 0, "lo": 0}, (1, 0), "mi_fwd", span=False)
def forward_rows(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward lattice, s-major: returns (p_rows [S+1, B, T+1] float32,
    -inf outside each utterance's boundary rectangle, and scores [B]
    float32).  ``px_rows``/``py_rows`` are unmasked; the boundary and the
    optional band ``lo <= s < lo + K`` are masked inside.  On a CUDA tensor:
    the sweep kernel's forward phase, any T."""
    if not _kernel_route(px_rows, impl):
        return _forward_rows_plain(px_rows, py_rows, boundary, lo, K)
    S, B, T1, T, code = _check_cuda(px_rows, py_rows, boundary, lo)
    _check_index(S, B, T, S + 1)
    p_rows = torch.empty((S + 1, B, T + 1), dtype=torch.float32, device=px_rows.device)
    scores = torch.empty((B,), dtype=torch.float32, device=px_rows.device)
    if B == 0:
        return p_rows, scores
    lib = _build.load_library()
    err = lib.frt_sweep_fwd(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(boundary),
        _build.ptr(lo), int(K), S, B, T, int(T1 == T),
        _build.ptr(p_rows), _build.ptr(scores), _SWEEP_THREADS, code,
        _build.stream_ptr(px_rows.device),
    )
    _build.check(err, "sweep_fwd")
    LAUNCHES["fwd"] += 1
    return p_rows, scores


@partitioned({"px_rows": 1, "py_rows": 1, "p_rows": 1, "boundary": 0, "ans_grad": 0, "lo": 0}, (1, 1), "mi_bwd",
             span=False)
def backward_rows(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    p_rows: torch.Tensor,
    boundary: torch.Tensor,
    ans_grad: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occupancy backward, s-major, seeded with ``ans_grad`` [B] at
    (s_end, t_end).  Returns (px_grad [S, B, T'], py_grad [S+1, B, T]) in
    the storage dtype of px/py.  On a CUDA tensor: the sweep kernel's
    backward phase, any T; it reads p only inside each rectangle, and hands
    rows between its strips through a (2, B, T+1) float32 scratch."""
    if not _kernel_route(px_rows, impl):
        return _backward_rows_plain(px_rows, py_rows, p_rows, boundary, ans_grad, lo, K)
    S, B, T1, T, code = _check_cuda(
        px_rows, py_rows, boundary, lo,
        extra=(("p_rows", p_rows), ("ans_grad", ans_grad)),
    )
    _check_p(p_rows, ans_grad, S, B, T)
    _check_index(S, B, T, S + 1)
    px_grad = torch.empty_like(px_rows)
    py_grad = torch.empty_like(py_rows)
    if B == 0:
        return px_grad, py_grad
    hand = torch.empty((2, B, T + 1), dtype=torch.float32, device=px_rows.device)
    lib = _build.load_library()
    err = lib.frt_sweep_bwd(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(p_rows),
        _build.ptr(boundary), _build.ptr(lo), int(K), _build.ptr(ans_grad),
        S, B, T, int(T1 == T), _build.ptr(hand), _build.ptr(px_grad),
        _build.ptr(py_grad), _SWEEP_THREADS, code, _build.stream_ptr(px_rows.device),
    )
    _build.check(err, "sweep_bwd")
    LAUNCHES["bwd"] += 1
    return px_grad, py_grad


def forward_rows_scan(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward_rows` by the row-scan kernel (T <= 14,271); the plain
    version on a CPU tensor."""
    if not _kernel_route(px_rows, impl):
        return _forward_rows_plain(px_rows, py_rows, boundary, lo, K)
    S, B, T1, T, nt, code = _check_split(px_rows, py_rows, boundary, lo)
    p_rows = torch.empty((S + 1, B, T + 1), dtype=torch.float32, device=px_rows.device)
    scores = torch.empty((B,), dtype=torch.float32, device=px_rows.device)
    if B == 0:
        return p_rows, scores
    lib = _build.load_library()
    err = lib.frt_scan_fwd(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(boundary),
        _build.ptr(lo), int(K), S, B, T, int(T1 == T),
        _build.ptr(p_rows), _build.ptr(scores), nt, code,
        _build.stream_ptr(px_rows.device),
    )
    _build.check(err, "scan_fwd")
    LAUNCHES["scan_fwd"] += 1
    return p_rows, scores


def backward_rows_scan(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    p_rows: torch.Tensor,
    boundary: torch.Tensor,
    ans_grad: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`backward_rows` by the row-scan kernel (T <= 14,271); the plain
    version on a CPU tensor."""
    if not _kernel_route(px_rows, impl):
        return _backward_rows_plain(px_rows, py_rows, p_rows, boundary, ans_grad, lo, K)
    S, B, T1, T, nt, code = _check_split(
        px_rows, py_rows, boundary, lo,
        extra=(("p_rows", p_rows), ("ans_grad", ans_grad)),
    )
    _check_p(p_rows, ans_grad, S, B, T)
    px_grad = torch.empty_like(px_rows)
    py_grad = torch.empty_like(py_rows)
    if B == 0:
        return px_grad, py_grad
    lib = _build.load_library()
    err = lib.frt_scan_bwd(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(p_rows),
        _build.ptr(boundary), _build.ptr(lo), int(K), _build.ptr(ans_grad),
        S, B, T, int(T1 == T), _build.ptr(px_grad), _build.ptr(py_grad), nt, code,
        _build.stream_ptr(px_rows.device),
    )
    _build.check(err, "scan_bwd")
    LAUNCHES["scan_bwd"] += 1
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


@partitioned({"px_rows": 1, "py_rows": 1, "boundary": 0, "lo": 0}, (0, 1, 1), "mi_fused", span=False)
def fused_rows(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward and occupancy backward (seed 1) in one launch, s-major:
    returns (scores [B] float32, px_grad [S, B, T'], py_grad [S+1, B, T]),
    the bits :func:`forward_rows` then :func:`backward_rows` with
    ``ans_grad = 1`` give (the same phases of the same kernel).  p and the
    backward's two hand-off rows go to a float32 scratch tensor (S+3, B,
    T+1) that is not returned; the kernel keeps no row in shared memory, so
    T has no cap beyond the scratch's int32 indexing."""
    if not _kernel_route(px_rows, impl):
        return fused_rows_plain(px_rows, py_rows, boundary, lo, K)
    S, B, T1, T, code = _check_cuda(px_rows, py_rows, boundary, lo)
    _check_index(S, B, T, S + 3)
    dev = px_rows.device
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    px_grad = torch.empty_like(px_rows)
    py_grad = torch.empty_like(py_rows)
    if B == 0:
        return scores, px_grad, py_grad
    p_scratch = torch.empty((S + 3, B, T + 1), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = lib.frt_wavefront_fused(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(boundary),
        _build.ptr(lo), int(K), S, B, T, int(T1 == T),
        _build.ptr(p_scratch), _build.ptr(scores), _build.ptr(px_grad),
        _build.ptr(py_grad), _SWEEP_THREADS, code, _build.stream_ptr(dev),
    )
    _build.check(err, "wavefront_fused")
    LAUNCHES["fused"] += 1
    return scores, px_grad, py_grad
