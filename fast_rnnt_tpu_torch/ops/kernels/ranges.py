"""Pruning-window starts: wrapper of the CUDA kernels in ``csrc/ranges.cu``
and their plain PyTorch versions.

Replaces the Pallas TPU kernel ``fast_rnnt_tpu/ops/kernels/ranges.py``
``_kernel`` (:64, entry ``window_argmax_rows_pallas`` :136) with its fused
post-pass: the window argmax (a grid of 32-frame tiles over every SM), then
the boundary padding and the monotone / step-bound repair (one block per
utterance), in one call.

A CPU tensor runs the plain version (``pruning._window_starts_plain``: the
cumsum-difference argmax, then ``adjust_pruning_lower_bound``); a CUDA
tensor launches the kernels or raises.  The route follows
``recursion.set_default_impl``, as the JAX package's ranges follow its
recursion impl.  ``window_argmax_kernel_order`` is
the kernels' raw argmax in their own float32 summation order, the
reference that their starts are held to exactly on the card.
"""

from __future__ import annotations

import torch

from ..pruning import _window_starts_plain
from ..recursion import _kernel_route
from . import _build
from .wavefront import _STORAGE  # storage dtype -> the kernels' dtype code

__all__ = ["window_starts", "window_starts_plain", "window_argmax_kernel_order", "LAUNCHES"]

LAUNCHES = {"ranges": 0}

_MAX_SMEM = 232_448

window_starts_plain = _window_starts_plain


def window_argmax_kernel_order(gy: torch.Tensor, gx: torch.Tensor, K: int) -> torch.Tensor:
    """The ranges kernel's raw window argmax, (B, T) int32: for each window
    start k in [0, S+1-K] the K rows of ``gy`` (S+1, B, T) added directly in
    row order, ``gy[k] + gy[k+1] + ... + gy[k+K-1]``, then ``- gx[k-1]``
    (``gx`` (S, B, T'), read at [:, :, :T]; no px term at k = 0), in float32
    whatever the storage dtype; the first maximum kept."""
    S1, B, T = gy.shape
    gy, gx = gy.float(), gx[:, :, :T].float()
    nk = S1 - K + 1
    a = gy[:nk]
    for j in range(1, K):
        a = a + gy[j:j + nk]
    a = torch.cat([a[:1], a[1:] - gx[:nk - 1]])
    return torch.argmax(a, dim=0).to(torch.int32)


def window_starts(
    py_grad_rows: torch.Tensor,
    px_grad_rows: torch.Tensor,
    K: int,
    boundary: torch.Tensor,
    adjust_step: int,
) -> torch.Tensor:
    """(B, T) int32 repaired window starts from the occupancies
    ``py_grad_rows`` (S+1, B, T) and ``px_grad_rows`` (S, B, T') (only
    ``[:, :, :T]`` is read), both float32, bf16 or float16, summed in
    float32; ``K`` is the window width (1 <= K <= S+1)."""
    if not _kernel_route(py_grad_rows):
        return _window_starts_plain(py_grad_rows, px_grad_rows, K, boundary, adjust_step)
    S1, B, T = py_grad_rows.shape
    S, Bx, T1x = px_grad_rows.shape
    if S != S1 - 1 or Bx != B or T1x < T:
        raise ValueError(
            f"px_grad_rows {tuple(px_grad_rows.shape)} does not fit py_grad_rows "
            f"{tuple(py_grad_rows.shape)}"
        )
    if not 1 <= K <= S1:
        raise ValueError(f"K={K} out of range for S+1={S1}")
    dev = py_grad_rows.device
    dtype = py_grad_rows.dtype
    # bf16 / f16 occupancies (a narrow lattice) are read as they are stored
    # and summed in float32, as the plain version and the JAX package sum them
    for name, x in (("py_grad_rows", py_grad_rows), ("px_grad_rows", px_grad_rows)):
        if x.device != dev or x.dtype not in _STORAGE or x.dtype != dtype or not x.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32, bfloat16 or float16 on {dev}, "
                            f"both of one dtype")
    if boundary.device != dev or boundary.dtype != torch.int32 or not boundary.is_contiguous():
        raise TypeError(f"boundary must be a contiguous int32 tensor on {dev}")
    if tuple(boundary.shape) != (B, 4):
        raise ValueError(f"boundary shape {tuple(boundary.shape)} != ({B}, 4)")
    nt = min(1024, max(32, -(-T // 32) * 32))
    if (T + nt) * 4 > _MAX_SMEM:
        raise ValueError(f"T={T} needs more shared memory than a block has")
    out = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B == 0 or T == 0:
        return out
    raw = torch.empty((B, T), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    p = _build.ptr
    err = lib.frt_ranges(
        p(py_grad_rows), p(px_grad_rows), p(boundary), S1, B, T, T1x, int(K), int(adjust_step),
        p(raw), p(out), nt, _STORAGE[dtype], _build.stream_ptr(dev),
    )
    _build.check(err, "ranges")
    LAUNCHES["ranges"] += 1
    return out
