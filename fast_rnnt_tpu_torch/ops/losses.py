"""RNN-T losses (PyTorch port of ``fast_rnnt_tpu/ops/losses.py``): the
two-stage pruned pipeline for the additive joiner."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.validation import check_rnnt_inputs
from .lattice import band_mask_rows_smajor, get_rnnt_logprobs_rows
from .pruning import get_rnnt_prune_ranges_rows
from .recursion import _normalize_boundary, mutual_information_rows

__all__ = ["rnnt_loss_simple_pruned"]


def _apply_delay_penalty_rows(
    px_rows: torch.Tensor,
    boundary: Optional[torch.Tensor],
    rnnt_type: str,
    delay_penalty: float,
) -> torch.Tensor:
    """Add ``((t_end - 1) / 2 - t) * delay_penalty`` to the (S, B, T') px
    rows: k2's delay penalty, which favours emitting symbols early."""
    if delay_penalty <= 0.0:
        return px_rows
    S, B, T0 = px_rows.shape
    T = T0 if rnnt_type != "regular" else T0 - 1
    dt, dev = px_rows.dtype, px_rows.device
    if boundary is None:
        offset = torch.full((1, 1, 1), (T - 1) / 2.0, dtype=dt, device=dev)
    else:
        offset = ((boundary[:, 3].to(device=dev, dtype=dt) - 1.0) / 2.0)[None, :, None]
    penalty = offset - torch.arange(T0, dtype=dt, device=dev)[None, None, :]
    return px_rows + penalty * delay_penalty


def _reduce(negated_loss: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    if reduction == "none" or reduction is None:
        return -negated_loss
    if reduction == "mean":
        return -torch.mean(negated_loss)
    if reduction == "sum":
        return -torch.sum(negated_loss)
    raise ValueError(f"reduction should be ('none' | 'mean' | 'sum'), given {reduction}")


def rnnt_loss_simple_pruned(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    s_range: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    delay_penalty: float = 0.0,
    reduction: Optional[str] = "mean",
    lattice_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage pruned RNN-T loss for the additive joiner, building the
    (px, py) lattice once:

      1. the simple loss with occupancies,
      2. pruning ranges from the occupancies,
      3. the pruned loss on the same lattice, band-masked inside the
         recursion.

    Returns (simple_loss, pruned_loss, ranges [B, T, s_range']); the losses
    are reduced per ``reduction``.  ``lattice_dtype`` stores the lattice in
    a narrower float (the CUDA kernels take float32 only so far).
    """
    check_rnnt_inputs(
        lm=lm, am=am, symbols=symbols,
        termination_symbol=termination_symbol, boundary=boundary,
    )
    if rnnt_type == "constrained" and s_range < 2:
        # a width-1 band makes every constrained px arc -inf
        raise ValueError("constrained RNN-T needs s_range >= 2")
    boundary = _normalize_boundary(
        boundary, am.shape[0], symbols.shape[1], am.shape[1], device=am.device
    )
    if rnnt_type == "constrained":
        # build the un-constrained base: the constrained px += py[1:] must
        # happen after band masking for the pruned stage
        px0_rows, py_rows = get_rnnt_logprobs_rows(
            lm, am, symbols, termination_symbol, "modified", boundary
        )
        px_simple_rows = px0_rows + py_rows[1:]
    else:
        px_simple_rows, py_rows = get_rnnt_logprobs_rows(
            lm, am, symbols, termination_symbol, rnnt_type, boundary,
            out_dtype=lattice_dtype if delay_penalty <= 0.0 else None,
        )
        px0_rows = px_simple_rows

    px_simple_rows = _apply_delay_penalty_rows(px_simple_rows, boundary, rnnt_type, delay_penalty)
    if lattice_dtype is not None:
        px_simple_rows = px_simple_rows.to(lattice_dtype)
        px0_rows = px0_rows.to(lattice_dtype)
        py_rows = py_rows.to(lattice_dtype)
    neg_simple, (gx_rows, gy_rows) = mutual_information_rows(
        px_simple_rows, py_rows, boundary, calc_gradients=True
    )
    ranges = get_rnnt_prune_ranges_rows(gx_rows, gy_rows, boundary, s_range)
    K = ranges.shape[2]
    lo = ranges[:, :, 0]

    if rnnt_type == "constrained":
        px_stage2 = px0_rows + band_mask_rows_smajor(py_rows, lo, K)[1:]
    else:
        px_stage2 = px0_rows
    px_stage2 = _apply_delay_penalty_rows(px_stage2, boundary, rnnt_type, delay_penalty)
    neg_pruned = mutual_information_rows(
        px_stage2, py_rows, boundary, lo=lo, s_range=K, calc_gradients=False
    )
    return _reduce(neg_simple, reduction), _reduce(neg_pruned, reduction), ranges
