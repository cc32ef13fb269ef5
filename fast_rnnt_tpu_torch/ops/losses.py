"""RNN-T losses (PyTorch port of ``fast_rnnt_tpu/ops/losses.py``): the
simple and smoothed losses of the additive joiner, the band-native pruned
loss and the two-stage pruned pipelines, and the losses of a real joiner's
logits (full, chunked and pruned).  Same argument order, defaults and
reductions as the JAX package; no ``impl`` argument: the port routes by
the tensor's device and the process-wide switches
``recursion.set_default_impl`` and ``lattice.set_lattice_build_impl``."""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..utils.validation import check_rnnt_inputs
from .lattice import (
    _check_rnnt_type,
    _finish,
    _neg_inf_column,
    band_mask_rows_smajor,
    get_rnnt_logprobs_joint,
    get_rnnt_logprobs_pruned,
    get_rnnt_logprobs_rows,
    get_rnnt_logprobs_smoothed_rows,
)
from .pruning import get_rnnt_prune_ranges_rows
from .recursion import _normalize_boundary, mutual_information_recursion, mutual_information_rows

__all__ = [
    "rnnt_loss",
    "rnnt_loss_chunked",
    "rnnt_loss_pruned",
    "rnnt_loss_simple",
    "rnnt_loss_pruned_simple",
    "rnnt_loss_simple_pruned",
    "rnnt_loss_smoothed",
    "rnnt_loss_smoothed_pruned",
]

LossOrLossAndGrads = Union[torch.Tensor, Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]


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


def _apply_delay_penalty(
    px: torch.Tensor,
    boundary: Optional[torch.Tensor],
    rnnt_type: str,
    delay_penalty: float,
) -> torch.Tensor:
    """(B, S, T')-major :func:`_apply_delay_penalty_rows`."""
    if delay_penalty <= 0.0:
        return px
    return _apply_delay_penalty_rows(px.movedim(1, 0), boundary, rnnt_type, delay_penalty).movedim(0, 1)


def _reduce(negated_loss: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    if reduction == "none" or reduction is None:
        return -negated_loss
    if reduction == "mean":
        return -torch.mean(negated_loss)
    if reduction == "sum":
        return -torch.sum(negated_loss)
    raise ValueError(f"reduction should be ('none' | 'mean' | 'sum'), given {reduction}")


def _full_recursion(px_rows, py_rows, lm, am, symbols, boundary, rnnt_type, delay_penalty,
                    reduction, calc_gradients) -> LossOrLossAndGrads:
    """The unpruned recursion on a built lattice, as the simple and smoothed
    losses share it; occupancies come back (B, S, T')-major."""
    px_rows = _apply_delay_penalty_rows(px_rows, boundary, rnnt_type, delay_penalty)
    bnd = _normalize_boundary(boundary, am.shape[0], symbols.shape[1], am.shape[1], device=am.device)
    out = mutual_information_rows(px_rows, py_rows, bnd, calc_gradients=calc_gradients)
    if calc_gradients:
        negated_loss, (gx_rows, gy_rows) = out
        return _reduce(negated_loss, reduction), (gx_rows.movedim(0, 1), gy_rows.movedim(0, 1))
    return _reduce(out, reduction)


def rnnt_loss_simple(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    delay_penalty: float = 0.0,
    reduction: Optional[str] = "mean",
    calc_gradients: bool = False,
) -> LossOrLossAndGrads:
    """Simple RNN-T loss (the joiner is just lm + am).  With
    ``calc_gradients`` also returns the occupancies ``(px_grad [B, S, T'],
    py_grad [B, S+1, T])`` that feed :func:`get_rnnt_prune_ranges`.

    Returns the loss ([B] for reduction "none", else a scalar), or
    ``(loss, (px_grad, py_grad))``."""
    check_rnnt_inputs(
        lm=lm, am=am, symbols=symbols,
        termination_symbol=termination_symbol, boundary=boundary,
    )
    px_rows, py_rows = get_rnnt_logprobs_rows(
        lm, am, symbols, termination_symbol, rnnt_type, boundary
    )
    return _full_recursion(px_rows, py_rows, lm, am, symbols, boundary, rnnt_type,
                           delay_penalty, reduction, calc_gradients)


def rnnt_loss_smoothed(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    lm_only_scale: float = 0.1,
    am_only_scale: float = 0.1,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    delay_penalty: float = 0.0,
    reduction: Optional[str] = "mean",
    calc_gradients: bool = False,
) -> LossOrLossAndGrads:
    """Smoothed simple RNN-T loss with lm-only / am-only interpolation
    (reference rnnt_loss.py:1369-1494); results as :func:`rnnt_loss_simple`."""
    check_rnnt_inputs(
        lm=lm, am=am, symbols=symbols,
        termination_symbol=termination_symbol, boundary=boundary,
    )
    px_rows, py_rows = get_rnnt_logprobs_smoothed_rows(
        lm, am, symbols, termination_symbol, lm_only_scale, am_only_scale, boundary, rnnt_type
    )
    return _full_recursion(px_rows, py_rows, lm, am, symbols, boundary, rnnt_type,
                           delay_penalty, reduction, calc_gradients)


def _recursion_loss(px, py, boundary, rnnt_type, delay_penalty, reduction,
                    calc_gradients) -> LossOrLossAndGrads:
    """The (B, S, T)-major recursion on a built lattice, as the joiner-logit
    losses share it."""
    px = _apply_delay_penalty(px, boundary, rnnt_type, delay_penalty)
    out = mutual_information_recursion(px, py, boundary, calc_gradients=calc_gradients)
    if calc_gradients:
        negated_loss, grads = out
        return _reduce(negated_loss, reduction), grads
    return _reduce(out, reduction)


def rnnt_loss(
    logits: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    delay_penalty: float = 0.0,
    reduction: Optional[str] = "mean",
    calc_gradients: bool = False,
) -> LossOrLossAndGrads:
    """Unpruned RNN-T loss from a full joiner output [B, T, S+1, C]
    (reference rnnt_loss.py:454-551); results as :func:`rnnt_loss_simple`."""
    check_rnnt_inputs(
        logits=logits, symbols=symbols,
        termination_symbol=termination_symbol, boundary=boundary,
    )
    px, py = get_rnnt_logprobs_joint(logits, symbols, termination_symbol, boundary, rnnt_type)
    return _recursion_loss(px, py, boundary, rnnt_type, delay_penalty, reduction, calc_gradients)


def rnnt_loss_chunked(
    joiner: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    am: torch.Tensor,
    lm: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    delay_penalty: float = 0.0,
    reduction: Optional[str] = "mean",
    chunk: int = 64,
    calc_gradients: bool = False,
) -> LossOrLossAndGrads:
    """Unpruned real-joiner RNN-T loss without materializing the joiner
    output: the joiner runs on ``chunk`` frames at a time under
    ``torch.utils.checkpoint``, so each chunk's [B, chunk, S+1, C] logits
    exist only while its px/py columns are made, in the forward and again
    in the backward.

    Args:
      joiner: ``joiner(am_chunk [B, Tc, Da], lm [B, S+1, Dl]) -> logits
        [B, Tc, S+1, C]``.
      am: [B, T, Da] encoder output; lm: [B, S+1, Dl] predictor output.
      chunk: frames per joiner call.

    Other arguments and the result are as :func:`rnnt_loss`'s."""
    check_rnnt_inputs(symbols=symbols, termination_symbol=termination_symbol, boundary=boundary)
    _check_rnnt_type(rnnt_type)

    def chunk_fn(am_c):
        # a chunk's "modified" lattice is its raw px/py columns
        return get_rnnt_logprobs_joint(joiner(am_c, lm), symbols, termination_symbol, None,
                                       "modified")

    cols = [checkpoint(chunk_fn, am[:, i : i + chunk], use_reentrant=False)
            for i in range(0, am.shape[1], chunk)]
    px = torch.cat([c[0] for c in cols], dim=2)  # [B, S, T]
    py = torch.cat([c[1] for c in cols], dim=2)  # [B, S+1, T]
    if rnnt_type == "regular":
        px = _neg_inf_column(px)
    px, py = _finish(px, py, rnnt_type, boundary)
    return _recursion_loss(px, py, boundary, rnnt_type, delay_penalty, reduction, calc_gradients)


def rnnt_loss_pruned(
    logits: torch.Tensor,
    symbols: torch.Tensor,
    ranges: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    delay_penalty: float = 0.0,
    reduction: Optional[str] = "mean",
) -> torch.Tensor:
    """Pruned RNN-T loss from a pruned joiner output [B, T, s_range, C]
    (reference rnnt_loss.py:1022-1130), the loss only; differentiable
    w.r.t. ``logits``.  Under autograd the recursion runs the forward and
    the occupancy backward kernels, or the fused kernel where
    ``recursion._FUSE_SCORES_VJP`` is set."""
    check_rnnt_inputs(
        logits=logits, symbols=symbols,
        termination_symbol=termination_symbol, boundary=boundary, ranges=ranges,
    )
    px, py = get_rnnt_logprobs_pruned(logits, symbols, ranges, termination_symbol, boundary,
                                      rnnt_type)
    return _recursion_loss(px, py, boundary, rnnt_type, delay_penalty, reduction, False)


def rnnt_loss_pruned_simple(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    ranges: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    delay_penalty: float = 0.0,
    reduction: Optional[str] = "mean",
    lattice_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Pruned RNN-T loss for the additive joiner, band-native: equal to the
    reference's ``do_rnnt_pruning`` -> ``rnnt_loss_pruned(am_p + lm_p, ...)``
    but the band ``ranges`` [B, T, s_range] is masked inside the recursion
    on the simple lattice, so the [B, T, s_range, C] pruned logits are never
    made."""
    check_rnnt_inputs(
        lm=lm, am=am, symbols=symbols,
        termination_symbol=termination_symbol, boundary=boundary, ranges=ranges,
    )
    _check_rnnt_type(rnnt_type)
    if rnnt_type == "constrained" and ranges.shape[2] < 2:
        raise ValueError("constrained RNN-T needs s_range >= 2")
    K = ranges.shape[2]
    lo = ranges[:, :, 0]
    px_rows, py_rows = _stage2_rows(
        lm, am, symbols, termination_symbol, boundary, rnnt_type, delay_penalty,
        lattice_dtype, lo, K,
    )
    bnd = _normalize_boundary(boundary, am.shape[0], symbols.shape[1], am.shape[1], device=am.device)
    neg = mutual_information_rows(px_rows, py_rows, bnd, lo=lo, s_range=K)
    return _reduce(neg, reduction)


def _stage2_rows(lm, am, symbols, termination_symbol, boundary, rnnt_type, delay_penalty,
                 lattice_dtype, lo, K):
    """The pruned stage's rows: the simple lattice (constrained: its px plus
    the band-masked py[1:], added after masking as the reference's pruned
    lattice does), delay-penalised and stored in ``lattice_dtype``."""
    base_type = "modified" if rnnt_type == "constrained" else rnnt_type
    # fuse the storage cast into the build when nothing is added to px
    cast = lattice_dtype if (delay_penalty <= 0.0 and rnnt_type != "constrained") else None
    px_rows, py_rows = get_rnnt_logprobs_rows(
        lm, am, symbols, termination_symbol, base_type, boundary, out_dtype=cast
    )
    if rnnt_type == "constrained":
        px_rows = px_rows + band_mask_rows_smajor(py_rows, lo, K)[1:]
    px_rows = _apply_delay_penalty_rows(px_rows, boundary, rnnt_type, delay_penalty)
    if lattice_dtype is not None:
        px_rows, py_rows = px_rows.to(lattice_dtype), py_rows.to(lattice_dtype)
    return px_rows, py_rows


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
    a narrower float (bfloat16 or float16 storage in the recursion
    kernels; the build runs in float32 and is cast after).
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


def rnnt_loss_smoothed_pruned(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    s_range: int,
    lm_only_scale: float = 0.1,
    am_only_scale: float = 0.1,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    delay_penalty: float = 0.0,
    reduction: Optional[str] = "mean",
    lattice_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-stage pruned pipeline with a smoothed first stage, the
    reference's own test recipe (simple_rnnt_loss_test.py:108-143): the
    smoothed lattice's occupancies steer the ranges, and the pruned stage is
    the band-masked simple lattice, which is what the additive joiner makes.

    Returns (smoothed_loss, pruned_loss, ranges [B, T, s_range'])."""
    check_rnnt_inputs(
        lm=lm, am=am, symbols=symbols,
        termination_symbol=termination_symbol, boundary=boundary,
    )
    if rnnt_type == "constrained" and s_range < 2:
        raise ValueError("constrained RNN-T needs s_range >= 2")
    boundary = _normalize_boundary(
        boundary, am.shape[0], symbols.shape[1], am.shape[1], device=am.device
    )
    px_sm, py_sm = get_rnnt_logprobs_smoothed_rows(
        lm, am, symbols, termination_symbol, lm_only_scale, am_only_scale, boundary, rnnt_type
    )
    px_sm = _apply_delay_penalty_rows(px_sm, boundary, rnnt_type, delay_penalty)
    if lattice_dtype is not None:
        px_sm, py_sm = px_sm.to(lattice_dtype), py_sm.to(lattice_dtype)
    neg_smoothed, (gx_rows, gy_rows) = mutual_information_rows(
        px_sm, py_sm, boundary, calc_gradients=True
    )
    ranges = get_rnnt_prune_ranges_rows(gx_rows, gy_rows, boundary, s_range)
    K = ranges.shape[2]
    lo = ranges[:, :, 0]
    px_rows, py_rows = _stage2_rows(
        lm, am, symbols, termination_symbol, boundary, rnnt_type, delay_penalty,
        lattice_dtype, lo, K,
    )
    neg_pruned = mutual_information_rows(px_rows, py_rows, boundary, lo=lo, s_range=K)
    return _reduce(neg_smoothed, reduction), _reduce(neg_pruned, reduction), ranges
