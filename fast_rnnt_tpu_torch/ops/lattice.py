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
    _assert_fp32_matmul(am)
    modified = rnnt_type == "modified"
    B, T, C = am.shape
    S = lm.shape[1] - 1
    # stability shifts only: the normalizer is shift-invariant
    am_max = am.amax(dim=2, keepdim=True).detach()
    lm_max = lm.amax(dim=2, keepdim=True).detach()
    am_probs = torch.exp(am - am_max)
    lm_probs = torch.exp(lm - lm_max)
    normalizers = torch.log(torch.einsum("bsc,btc->sbt", lm_probs, am_probs) + _TINY)
    normalizers = normalizers + lm_max.permute(1, 0, 2) + am_max.permute(2, 0, 1)

    sym, valid = _symbol_index(symbols, C)
    # px_am[s, b, t] = am[b, t, symbols[b, s]]
    px_am = torch.gather(am, 2, sym[:, None, :].expand(B, T, S))
    px_am = torch.where(valid[:, None, :], px_am, 0.0).permute(2, 0, 1)
    px_lm = torch.gather(lm[:, :S, :], 2, sym[:, :, None])
    px_lm = torch.where(valid[:, :, None], px_lm, 0.0).permute(1, 0, 2)  # (S, B, 1)
    px = px_am + px_lm
    if modified:
        norm_px = normalizers[:S]
    else:
        px = torch.cat([px, px.new_full((S, B, 1), NEG_INF)], dim=2)
        norm_px = torch.cat([normalizers[:S], normalizers.new_zeros((S, B, 1))], dim=2)
    px = px - norm_px

    py_am = am[:, :, termination_symbol][None]  # (1, B, T)
    py_lm = lm[:, :, termination_symbol].t()[:, :, None]  # (S+1, B, 1)
    py = py_am + py_lm - normalizers

    if not modified and boundary is not None:
        t = torch.arange(T + 1, device=px.device)[None, None, :]
        px = torch.where(t == boundary[:, 3].to(px.device)[None, :, None], NEG_INF, px)
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
