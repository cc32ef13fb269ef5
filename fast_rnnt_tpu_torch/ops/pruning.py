"""Pruning bounds from occupancies (PyTorch port of
``fast_rnnt_tpu/ops/pruning.py``): per frame, the s_range-wide symbol
window with the largest occupancy, repaired to be monotone, 0-based and
step-bounded (Pruned RNN-T paper, arXiv:2206.13236, section 3.2)."""

from __future__ import annotations

from typing import Tuple

import torch

from .recursion import monotonic_lower_bound

__all__ = [
    "adjust_pruning_lower_bound",
    "do_rnnt_pruning",
    "get_rnnt_prune_ranges",
    "get_rnnt_prune_ranges_rows",
]


def adjust_pruning_lower_bound(s_begin: torch.Tensor, s_range: int) -> torch.Tensor:
    """Make per-frame lower bounds monotone non-decreasing, starting at 0
    and stepping by < s_range, with the "magic transform"
    ``s' = -(s_begin - (s_range - 1) * t)``."""
    B, T = s_begin.shape
    t_ramp = (s_range - 1) * torch.arange(T, dtype=torch.int32, device=s_begin.device)
    s_begin = monotonic_lower_bound(s_begin.to(torch.int32))
    s_begin = -(s_begin - t_ramp)
    s_begin = monotonic_lower_bound(s_begin)
    s_begin = torch.clamp(s_begin, min=0)
    return -(s_begin - t_ramp)


def _window_scores(
    px_grad_rows: torch.Tensor, py_grad_rows: torch.Tensor, s_range: int
) -> torch.Tensor:
    """(S+2-s_range, B, T) scores of every window start k: the window sum of
    py_grad minus px_grad[k-1], in the padded cumsum-difference form.  At
    s_range = 1 the window is the row itself (exact)."""
    S1, B, T = py_grad_rows.shape
    T1 = px_grad_rows.shape[2]
    gy = py_grad_rows.float()
    if s_range == 1:
        blk = gy
    else:
        cumsum = torch.cat([gy.new_zeros((1, B, T)), torch.cumsum(gy, dim=0)], dim=0)
        blk = cumsum[s_range:] - cumsum[: S1 - s_range + 1]
    px_pad = torch.cat([px_grad_rows.new_zeros((1, B, T1)), px_grad_rows], dim=0)
    return blk - px_pad[: S1 - s_range + 1, :, :T].float()


def _window_argmax(
    px_grad_rows: torch.Tensor, py_grad_rows: torch.Tensor, s_range: int
) -> torch.Tensor:
    """Best window start per frame (B, T) int32; the first maximum wins."""
    scores = _window_scores(px_grad_rows, py_grad_rows, s_range)
    return torch.argmax(scores, dim=0).to(torch.int32)


def _window_starts_plain(
    py_grad_rows: torch.Tensor,
    px_grad_rows: torch.Tensor,
    s_range: int,
    boundary: torch.Tensor,
    adjust_step: int,
) -> torch.Tensor:
    """The plain version of the ranges kernel: window argmax, boundary
    padding, then the monotone / step-bound repair.  (B, T) int32."""
    s_begin = _window_argmax(px_grad_rows, py_grad_rows, s_range)
    B, T = s_begin.shape
    bnd = boundary.to(device=s_begin.device, dtype=torch.int32)
    # frames at/after each utterance's last real frame get the final window
    # start S - s_range + 1 (clipped at 0), so the last symbol is reachable
    t_idx = torch.arange(T, dtype=torch.int32, device=s_begin.device)[None, :]
    mask = t_idx < (bnd[:, 3:4] - 1)
    pad = torch.clamp(bnd[:, 2:3] - s_range + 1, min=0)
    s_begin = torch.where(mask, s_begin, pad)
    return adjust_pruning_lower_bound(s_begin, adjust_step)


def get_rnnt_prune_ranges_rows(
    px_grad_rows: torch.Tensor,
    py_grad_rows: torch.Tensor,
    boundary: torch.Tensor,
    s_range: int,
) -> torch.Tensor:
    """Per-frame symbol windows [B, T, s_range] from s-major occupancies
    (px_grad [S, B, T'], py_grad [S+1, B, T]).  ``s_range`` must be a Python
    int; above S it is clamped to S + 1.  The windows are integers, so no
    gradient flows back through them."""
    S, B, T1 = px_grad_rows.shape
    T = py_grad_rows.shape[-1]
    if not isinstance(s_range, int):
        raise TypeError("s_range must be a static Python int")
    if s_range > S:
        s_range = S + 1
    if T1 == T and s_range < 1:
        raise ValueError("modified/constrained RNN-T needs s_range >= 1")
    if T1 == T + 1 and s_range < 2:
        raise ValueError("regular RNN-T needs s_range >= 2")
    # modified/constrained emit at most one symbol per frame, so consecutive
    # starts may differ by at most 1
    adjust_step = 2 if T1 == T else s_range
    from .kernels import ranges

    s_begin = ranges.window_starts(
        py_grad_rows.detach().contiguous(),
        px_grad_rows.detach().contiguous(),
        s_range,
        boundary.to(torch.int32).contiguous(),
        adjust_step,
    )
    return s_begin[:, :, None] + torch.arange(s_range, dtype=torch.int32, device=s_begin.device)


def do_rnnt_pruning(
    am: torch.Tensor, lm: torch.Tensor, ranges: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prune encoder/predictor outputs to the per-frame symbol windows:
    ``am_pruned[b, t, k] = am[b, t]`` (a broadcast view) and ``lm_pruned[b,
    t, k] = lm[b, ranges[b, t, k]]``, both [B, T, s_range, C] (reference
    rnnt_loss.py:763-812).  A range outside [0, S] reads a row of zeros, as
    the JAX package's one-hot product does.  ``am_pruned`` keeps am's dtype;
    ``lm_pruned`` is at least float32 (a bf16 or f16 lm comes back float32),
    as the JAX package's ``preferred_element_type=float32`` product gives."""
    B, T, K = ranges.shape
    S1, C = lm.shape[1], lm.shape[2]
    am_pruned = am[:, :, None, :].expand(B, T, K, C)
    lm = lm.to(torch.promote_types(lm.dtype, torch.float32))
    # index S+1 is an appended zero row
    lm_pad = torch.cat([lm, lm.new_zeros((B, 1, C))], dim=1)
    rg = ranges.long()
    rg = torch.where((rg >= 0) & (rg < S1), rg, S1)
    lm_pruned = lm_pad[torch.arange(B, device=lm.device)[:, None, None], rg]
    return am_pruned, lm_pruned


def get_rnnt_prune_ranges(
    px_grad: torch.Tensor,
    py_grad: torch.Tensor,
    boundary: torch.Tensor,
    s_range: int,
) -> torch.Tensor:
    """(B, S, T)-major :func:`get_rnnt_prune_ranges_rows`."""
    return get_rnnt_prune_ranges_rows(
        px_grad.movedim(1, 0), py_grad.movedim(1, 0), boundary, s_range
    )
