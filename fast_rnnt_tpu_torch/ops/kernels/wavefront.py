"""Forward, occupancy-backward and fused lattice recursion: wrappers of the
CUDA kernel in ``csrc/wavefront_fused.cu`` and their plain PyTorch
versions.

Replaces the Pallas kernels ``fast_rnnt_tpu/ops/kernels/wavefront.py``
``_fwd_kernel`` (:224, entry ``forward_rows_pallas`` :366),
``_bwd_kernel`` (:420, entry ``backward_rows_pallas`` :558) and
``_fused_kernel`` (:623, entry ``fused_rows_pallas`` :799).  All three run
one diagonal-sweep kernel, instantiated on the phases it runs: the
forward alone (:func:`forward_rows`), the backward alone
(:func:`backward_rows`) or both (:func:`fused_rows`); seeded with ones, the
first two give the third's bits.  Over a lattice of more than one 128-row
strip a launch sweeps an utterance's strips at once, a block each, where
they fit on the device together (``BLOCKS`` counts the blocks launched).

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

from typing import Dict, Optional, Tuple

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
    "LAUNCHES",
    "BLOCKS",
]

# launches of the sweep kernel by the phases they run
LAUNCHES = {"fwd": 0, "bwd": 0, "fused": 0}
# blocks of the sweep launches: B x strips each where an utterance's strips
# run at once, B where each utterance's block sweeps them one after another
BLOCKS = {"sweep": 0}

forward_rows_plain = _forward_rows_plain
backward_rows_plain = _backward_rows_plain

# storage dtype -> the kernels' StorageCode (csrc/wavefront_fused.cu)
_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the sweep kernels' block: one warp sweeps a 128-row strip's diagonals,
# seven move its tiles between device and shared memory
_SWEEP_THREADS = 256
_STRIP = 128  # rows of a sweep strip (kStrip)
_RESIDENT: Dict[int, int] = {}  # device index -> sweep blocks it holds at once


def _strips(S: int) -> int:
    """128-row strips of a lattice of S+1 rows; the backward's hand-off rows."""
    return -(-(S + 1) // _STRIP)


def _strips_at_once(S: int, resident: int) -> int:
    """Strips a sweep launch sweeps at once, one block each per utterance:
    all of them where one utterance's blocks fit on the device together
    (``resident`` blocks), so that a block waits only on running ones; else
    1, each utterance's block sweeping its strips one after another (the
    schedule at one strip too)."""
    nk = _strips(S)
    return nk if nk <= resident else 1


def _counters(B: int, nk: int) -> int:
    """int32 counters of a launch with strips at once: the blocks' ticket
    and the forward's and backward's progress of each (utterance, strip)."""
    return 1 + 2 * B * nk


def _resident(dev: torch.device) -> int:
    """Sweep blocks the device holds at once (one a streaming multiprocessor
    on an H100), asked of the CUDA runtime once a device."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _RESIDENT:
        n = _build.load_library().frt_sweep_resident(i)
        _build.check(-n if n < 0 else 0, "sweep_resident")
        _RESIDENT[i] = n
    return _RESIDENT[i]


def _schedule(S: int, B: int, dev: torch.device) -> Tuple[int, Optional[torch.Tensor]]:
    """(strips at once, their counters or None) of a sweep launch."""
    nk = _strips_at_once(S, _resident(dev))
    ctr = torch.empty(_counters(B, nk), dtype=torch.int32, device=dev) if nk > 1 else None
    return nk, ctr


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
    nk, ctr = _schedule(S, B, px_rows.device)
    err = lib.frt_sweep_fwd(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(boundary),
        _build.ptr(lo), int(K), S, B, T, int(T1 == T),
        _build.ptr(p_rows), _build.ptr(scores), _SWEEP_THREADS, code, nk, _build.ptr(ctr),
        _build.stream_ptr(px_rows.device),
    )
    _build.check(err, "sweep_fwd")
    LAUNCHES["fwd"] += 1
    BLOCKS["sweep"] += B * nk
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
    rows between its 128-row strips through a (strips, B, T+1) float32
    scratch."""
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
    hand = torch.empty((_strips(S), B, T + 1), dtype=torch.float32, device=px_rows.device)
    lib = _build.load_library()
    nk, ctr = _schedule(S, B, px_rows.device)
    err = lib.frt_sweep_bwd(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(p_rows),
        _build.ptr(boundary), _build.ptr(lo), int(K), _build.ptr(ans_grad),
        S, B, T, int(T1 == T), _build.ptr(hand), _build.ptr(px_grad),
        _build.ptr(py_grad), _SWEEP_THREADS, code, nk, _build.ptr(ctr),
        _build.stream_ptr(px_rows.device),
    )
    _build.check(err, "sweep_bwd")
    LAUNCHES["bwd"] += 1
    BLOCKS["sweep"] += B * nk
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
    backward's hand-off rows, one a 128-row strip, go to a float32 scratch
    tensor (S+1+strips, B, T+1) that is not returned; the kernel keeps no
    row in shared memory, so T has no cap beyond the scratch's int32
    indexing."""
    if not _kernel_route(px_rows, impl):
        return fused_rows_plain(px_rows, py_rows, boundary, lo, K)
    S, B, T1, T, code = _check_cuda(px_rows, py_rows, boundary, lo)
    rows = S + 1 + _strips(S)
    _check_index(S, B, T, rows)
    dev = px_rows.device
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    px_grad = torch.empty_like(px_rows)
    py_grad = torch.empty_like(py_rows)
    if B == 0:
        return scores, px_grad, py_grad
    p_scratch = torch.empty((rows, B, T + 1), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    nk, ctr = _schedule(S, B, dev)
    err = lib.frt_wavefront_fused(
        _build.ptr(px_rows), _build.ptr(py_rows), _build.ptr(boundary),
        _build.ptr(lo), int(K), S, B, T, int(T1 == T),
        _build.ptr(p_scratch), _build.ptr(scores), _build.ptr(px_grad),
        _build.ptr(py_grad), _SWEEP_THREADS, code, nk, _build.ptr(ctr), _build.stream_ptr(dev),
    )
    _build.check(err, "wavefront_fused")
    LAUNCHES["fused"] += 1
    BLOCKS["sweep"] += B * nk
    return scores, px_grad, py_grad
