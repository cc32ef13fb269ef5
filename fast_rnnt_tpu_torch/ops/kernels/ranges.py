"""Pruning-window starts: wrapper of the CUDA kernel in ``csrc/ranges.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``fast_rnnt_tpu/ops/kernels/ranges.py``
``_kernel`` (:64, entry ``window_argmax_rows_pallas`` :136) with its fused
post-pass: the window argmax, the boundary padding and the monotone /
step-bound repair, in one launch.

A CPU tensor runs the plain version (``pruning._window_starts_plain``: the
cumsum-difference argmax, then ``adjust_pruning_lower_bound``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..pruning import _window_starts_plain
from . import _build

__all__ = ["window_starts", "window_starts_plain", "LAUNCHES"]

LAUNCHES = {"ranges": 0}

_MAX_SMEM = 232_448

window_starts_plain = _window_starts_plain


def window_starts(
    py_grad_rows: torch.Tensor,
    px_grad_rows: torch.Tensor,
    K: int,
    boundary: torch.Tensor,
    adjust_step: int,
) -> torch.Tensor:
    """(B, T) int32 repaired window starts from the occupancies
    ``py_grad_rows`` (S+1, B, T) and ``px_grad_rows`` (S, B, T') (only
    ``[:, :, :T]`` is read); ``K`` is the window width (1 <= K <= S+1)."""
    if not py_grad_rows.is_cuda:
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
    # occupancies stored in bf16 / f16 (a narrow lattice) are summed in
    # float32, as the plain version and the JAX package sum them
    if py_grad_rows.dtype in (torch.bfloat16, torch.float16):
        py_grad_rows = py_grad_rows.float()
    if px_grad_rows.dtype in (torch.bfloat16, torch.float16):
        px_grad_rows = px_grad_rows.float()
    for name, x in (("py_grad_rows", py_grad_rows), ("px_grad_rows", px_grad_rows)):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32 on {dev}")
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
    lib = _build.load_library()
    err = lib.frt_ranges(
        _build.ptr(py_grad_rows), _build.ptr(px_grad_rows), _build.ptr(boundary),
        S1, B, T, T1x, int(K), int(adjust_step), _build.ptr(out), nt,
        _build.stream_ptr(dev),
    )
    _build.check(err, "ranges")
    LAUNCHES["ranges"] += 1
    return out
