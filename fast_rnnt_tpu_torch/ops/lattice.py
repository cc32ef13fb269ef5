"""(px, py) lattice construction, s-major rows (PyTorch port of the rows
part of ``fast_rnnt_tpu/ops/lattice.py``).

Matmul precision: the JAX package contracts the normalizer at
``Precision.HIGHEST`` (fp32-faithful).  The port keeps that contract: the
CUDA build kernel accumulates plain fp32 FMAs, and the plain build's einsum
on a CUDA tensor requires TF32 to be off (``torch.backends.cuda.matmul.
allow_tf32`` False, PyTorch's default), which it asserts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .numerics import NEG_INF

__all__ = [
    "band_mask_rows_smajor",
    "fix_for_boundary",
    "get_rnnt_logprobs_rows",
    "get_rnnt_logprobs_smoothed_rows",
]

RNNT_TYPES = ("regular", "modified", "constrained")

# Guard for log(0) in the normalizer: the smallest normal float32.
_TINY = float(np.finfo(np.float32).tiny)


def _check_rnnt_type(rnnt_type: str) -> None:
    if rnnt_type not in RNNT_TYPES:
        raise ValueError(f"rnnt_type must be one of {RNNT_TYPES}, got {rnnt_type!r}")


def _assert_fp32_matmul(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the lattice normalizer is fp32-faithful: turn TF32 off "
            "(torch.backends.cuda.matmul.allow_tf32 = False)"
        )


def _symbol_index(symbols: torch.Tensor, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index clamped to [0, C), mask of symbols in [0, C)).  The JAX
    package gathers symbols through a one-hot, so a symbol outside the
    vocabulary reads 0; callers zero the gathered value where the mask is
    False.  No value is read back to the host."""
    sym = symbols.long()
    return sym.clamp(0, C - 1), (sym >= 0) & (sym < C)


def fix_for_boundary(px: torch.Tensor, boundary: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Set ``px[b, :, boundary[b, 3]] = -inf`` on (B, S, T+1) px (regular
    only): no symbol is emitted on an utterance's one-past-the-end frame."""
    if boundary is None:
        return px
    t = torch.arange(px.shape[2], device=px.device)[None, None, :]
    return torch.where(t == boundary[:, 3].to(px.device)[:, None, None], NEG_INF, px)


def _build_rows_plain(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    rnnt_type: str = "regular",
    boundary: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain einsum build (port of the XLA branch of
    ``get_rnnt_logprobs_rows``), regular or modified.  The per-(s, t)
    normalizer is one [S+1, C] x [C, T] product per utterance."""
    modified = rnnt_type == "modified"
    normalizers = _normalizers_plain(lm, am)[0]
    px_am, px_lm = _px_gathers(lm, am, symbols)
    px = _pad_px(px_am + px_lm, modified) - _pad_px(normalizers[:-1], modified, 0.0)
    py = _py_gathers(lm, am, termination_symbol) - normalizers
    if not modified and boundary is not None:
        px = _kill_t_end(px, boundary[:, 3])
    return px, py


def _normalizers_plain(lm: torch.Tensor, am: torch.Tensor):
    """(normalizers (S+1, B, T), am_max (B, T, 1), am_probs, lm_max (B, S+1,
    1), lm_probs): the joint normalizer log sum_c exp(lm + am) as one
    [S+1, C] x [C, T] product per utterance, on max-shifted exps."""
    _assert_fp32_matmul(am)
    # stability shifts only: the normalizer is shift-invariant
    am_max = am.amax(dim=2, keepdim=True).detach()
    lm_max = lm.amax(dim=2, keepdim=True).detach()
    am_probs = torch.exp(am - am_max)
    lm_probs = torch.exp(lm - lm_max)
    normalizers = torch.log(torch.einsum("bsc,btc->sbt", lm_probs, am_probs) + _TINY)
    normalizers = normalizers + lm_max.permute(1, 0, 2) + am_max.permute(2, 0, 1)
    return normalizers, am_max, am_probs, lm_max, lm_probs


def _px_gathers(lm: torch.Tensor, am: torch.Tensor, symbols: torch.Tensor):
    """(px_am (S, B, T) = am[b, t, sym_s], px_lm (S, B, 1) = lm[b, s, sym_s]),
    0 where a symbol is outside [0, C)."""
    B, T, C = am.shape
    S = symbols.shape[1]
    sym, valid = _symbol_index(symbols, C)
    px_am = torch.gather(am, 2, sym[:, None, :].expand(B, T, S))
    px_am = torch.where(valid[:, None, :], px_am, 0.0).permute(2, 0, 1)
    px_lm = torch.gather(lm[:, :S, :], 2, sym[:, :, None])
    px_lm = torch.where(valid[:, :, None], px_lm, 0.0).permute(1, 0, 2)
    return px_am, px_lm


def _py_gathers(lm: torch.Tensor, am: torch.Tensor, blank: int) -> torch.Tensor:
    """am[b, t, blank] + lm[b, s, blank] as (S+1, B, T)."""
    return am[:, :, blank][None] + lm[:, :, blank].t()[:, :, None]


def _pad_px(x: torch.Tensor, modified: bool, fill: float = NEG_INF) -> torch.Tensor:
    """Regular px rows get the appended t = T column (``fill``)."""
    if modified:
        return x
    S, B, _ = x.shape
    return torch.cat([x, x.new_full((S, B, 1), fill)], dim=2)


def _kill_t_end(px: torch.Tensor, t_end: torch.Tensor) -> torch.Tensor:
    """-inf at each utterance's ``t_end[b]`` column of (S, B, T+1) px rows
    (a t_end of -1 kills nothing)."""
    t = torch.arange(px.shape[2], device=px.device)[None, None, :]
    return torch.where(t == t_end.to(px.device)[None, :, None], NEG_INF, px)


def _smoothing_scales(lm_only_scale: float, am_only_scale: float):
    """(combined, lm-only, am-only) scales, each exact zero floored at 1e-20
    so that 0 * -inf does not make a NaN (the reference's floor)."""
    scales = (1.0 - lm_only_scale - am_only_scale, lm_only_scale, am_only_scale)
    return tuple(1.0e-20 if x == 0.0 else x for x in scales)


def _build_smoothed_rows_plain(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    lm_only_scale: float = 0.1,
    am_only_scale: float = 0.1,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain smoothed build (port of the XLA branch of
    ``get_rnnt_logprobs_smoothed_rows``): the combined, lm-only and am-only
    lattices, interpolated."""
    modified = rnnt_type != "regular"
    S = lm.shape[1] - 1
    normalizers, am_max, am_probs, lm_max, lm_probs = _normalizers_plain(lm, am)
    am_max_r = am_max.permute(2, 0, 1)  # (1, B, T)
    lm_max_r = lm_max.permute(1, 0, 2)  # (S+1, B, 1)
    # unigram LM: mean of the normalized lm probs over (B, S+1), padding
    # included, as the reference does
    lmonly_norm = lm_probs.sum(dim=2, keepdim=True)  # (B, S+1, 1)
    unigram = (lm_probs / lmonly_norm).mean(dim=(0, 1)) + _TINY  # (C,)
    amonly_norm = torch.log(torch.einsum("btc,c->bt", am_probs, unigram))[None] + am_max_r
    uni_log = torch.log(unigram)
    lmonly_norm = torch.log(lmonly_norm).permute(1, 0, 2) + lm_max_r  # (S+1, B, 1)

    px_am, px_lm = _px_gathers(lm, am, symbols)
    sym, valid = _symbol_index(symbols, am.shape[2])
    px_uni = torch.where(valid, uni_log[sym], 0.0).t()[:, :, None]  # (S, B, 1)
    px =_pad_px(px_am + px_lm, modified) - _pad_px(normalizers[:S], modified, 0.0)
    px_amonly = _pad_px(px_am + px_uni, modified) - _pad_px(
        amonly_norm.expand(S, -1, -1), modified, 0.0
    )
    px_lmonly = px_lm - lmonly_norm[:S]

    py_am = am[:, :, termination_symbol][None]  # (1, B, T)
    py = _py_gathers(lm, am, termination_symbol) - normalizers
    py_amonly = py_am + uni_log[termination_symbol] - amonly_norm
    py_lmonly = lm[:, :, termination_symbol].t()[:, :, None] - lmonly_norm

    c, l, a = _smoothing_scales(lm_only_scale, am_only_scale)
    px = px * c + px_lmonly * l + px_amonly * a
    py = py * c + py_lmonly * l + py_amonly * a
    if rnnt_type == "regular" and boundary is not None:
        px = _kill_t_end(px, boundary[:, 3])
    elif rnnt_type == "constrained":
        px = px + py[1:]
    return px, py


def get_rnnt_logprobs_rows(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    rnnt_type: str = "regular",
    boundary: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce the simple (additive-joiner) RNN-T problem to s-major
    ``px_rows`` [S, B, T+1] (regular) or [S, B, T] (modified/constrained)
    and ``py_rows`` [S+1, B, T].

    Args:
      lm: [B, S+1, C] language-model logits.
      am: [B, T, C] acoustic-model logits.
      symbols: int [B, S].
      termination_symbol: blank id in [0, C).
      boundary: optional int [B, 4] rows [s_begin, t_begin, s_end, t_end].
      out_dtype: optional storage dtype of the returned lattice.

    On a CUDA tensor the build always runs the kernel of
    ``kernels/latbuild.py``; on a CPU tensor, the plain einsum build.
    """
    _check_rnnt_type(rnnt_type)
    from .kernels import latbuild

    return latbuild.lattice_rows(
        lm, am, symbols, termination_symbol, rnnt_type, boundary, out_dtype=out_dtype
    )


def get_rnnt_logprobs_smoothed_rows(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    lm_only_scale: float = 0.1,
    am_only_scale: float = 0.1,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """s-major smoothed lattice: ``combined * (1 - l - a) + lm_only * l +
    am_only * a`` over the additive joiner's combined, lm-only and am-only
    lattices, with a unigram LM for the am-only one (reference
    rnnt_loss.py:1132-1367).  Same shapes as :func:`get_rnnt_logprobs_rows`.

    On a CUDA tensor the am-heavy part runs the smoothed build kernel of
    ``kernels/latbuild.py`` (``lattice_rows_smoothed``); on a CPU tensor,
    the plain einsum build.
    """
    _check_rnnt_type(rnnt_type)
    if not am.is_cuda:
        return _build_smoothed_rows_plain(
            lm, am, symbols, termination_symbol, lm_only_scale, am_only_scale,
            boundary, rnnt_type,
        )
    from .kernels import latbuild

    return latbuild.lattice_rows_smoothed(
        lm, am, symbols, termination_symbol, lm_only_scale, am_only_scale,
        boundary, rnnt_type,
    )


def band_mask_rows_smajor(x_rows: torch.Tensor, lo: torch.Tensor, K: int) -> torch.Tensor:
    """Mask (S', B, T') rows to -inf outside ``lo[b, t] <= s < lo[b, t] + K``
    (lo edge-padded for a regular px's extra t = T column)."""
    Sx, B, T1 = x_rows.shape
    lo = lo.to(device=x_rows.device, dtype=torch.int32)
    if T1 == lo.shape[1] + 1:
        lo = torch.cat([lo, lo[:, -1:]], dim=1)
    lo3 = lo[None]
    s_i = torch.arange(Sx, dtype=torch.int32, device=x_rows.device)[:, None, None]
    return torch.where((s_i >= lo3) & (s_i < lo3 + K), x_rows, NEG_INF)
