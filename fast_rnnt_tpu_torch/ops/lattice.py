"""(px, py) lattice construction (PyTorch port of
``fast_rnnt_tpu/ops/lattice.py``): the s-major rows builds of the additive
joiner, their (B, S, T)-major forms, and the lattices of a real joiner's
full or pruned logits.

Matmul precision: the JAX package contracts the normalizer at
``Precision.HIGHEST`` (fp32-faithful).  The port keeps that contract: the
CUDA build kernel runs its float32 products as 3xTF32 on the tensor cores
(~2^-21 relative, ``csrc/wgmma.cuh``), and the plain build's einsum
on a CUDA tensor requires TF32 to be off (``torch.backends.cuda.matmul.
allow_tf32`` False, PyTorch's default), which it asserts.  The joiner-logit
lattices need no matmul: the JAX package's one-hot einsums there were TPU
gather workarounds, and the port gathers, which is exact.

Build route: the kernels of ``kernels/latbuild.py`` on a CUDA tensor, the
plain einsum builds on a CPU tensor; :func:`set_lattice_build_impl` pins
either, forward and VJP together.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .numerics import NEG_INF

__all__ = [
    "band_mask_rows",
    "band_mask_rows_smajor",
    "fix_for_boundary",
    "get_rnnt_logprobs",
    "get_rnnt_logprobs_joint",
    "get_rnnt_logprobs_pruned",
    "get_rnnt_logprobs_pruned_simple",
    "get_rnnt_logprobs_rows",
    "get_rnnt_logprobs_smoothed",
    "get_rnnt_logprobs_smoothed_rows",
    "roll_by_shifts",
    "scatter_window",
    "set_lattice_build_impl",
]

RNNT_TYPES = ("regular", "modified", "constrained")

# Guard for log(0) in the normalizer: the smallest normal float32.
_TINY = float(np.finfo(np.float32).tiny)


# The simple and smoothed builds' route (the JAX package's switch,
# fast_rnnt_tpu/ops/lattice.py:84): "auto", the kernels on a CUDA tensor and
# the plain builds on a CPU tensor; "kernel", the kernels (a CPU tensor
# raises); "plain", the plain builds on any device.
_BUILD_IMPLS = ("auto", "kernel", "plain")
_LATTICE_BUILD_IMPL = "auto"


def set_lattice_build_impl(impl: str) -> None:
    """Select the simple and smoothed lattice builds' route, forward and
    VJP: ``"auto"`` | ``"kernel"`` | ``"plain"``.  Nothing reroutes
    silently: ``"kernel"`` on a CPU tensor raises ValueError, and so does
    an unknown name."""
    global _LATTICE_BUILD_IMPL
    if impl not in _BUILD_IMPLS:
        raise ValueError(f"lattice build impl must be one of {_BUILD_IMPLS}, got {impl!r}")
    _LATTICE_BUILD_IMPL = impl


def _build_kernel_route(x: torch.Tensor) -> bool:
    """Whether the builds run their kernels on ``x`` (see
    :func:`set_lattice_build_impl`)."""
    if _LATTICE_BUILD_IMPL == "plain":
        return False
    if _LATTICE_BUILD_IMPL == "kernel" and not x.is_cuda:
        raise ValueError(f'set_lattice_build_impl("kernel"): a tensor on {x.device} has no kernel')
    return x.is_cuda


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
    # float32 px gathers (the JAX package's one-hot einsum emits float32)
    px = _pad_px(px_am.float() + px_lm, modified) - _pad_px(normalizers[:-1], modified, 0.0)
    py = _py_gathers(lm, am, termination_symbol) - normalizers
    if not modified and boundary is not None:
        px = _kill_t_end(px, boundary[:, 3])
    return px, py


def _normalizers_plain(lm: torch.Tensor, am: torch.Tensor):
    """(normalizers (S+1, B, T), am_max (B, T, 1), am_probs, lm_max (B, S+1,
    1), lm_probs): the joint normalizer log sum_c exp(lm + am) as one
    [S+1, C] x [C, T] product per utterance, on max-shifted exps.  The exps
    stay in the inputs' dtype (bf16 inputs: rounded as ``jnp.exp`` on bf16
    rounds them) and the product and the normalizers are float32, as the
    JAX package's ``preferred_element_type=float32`` contraction gives."""
    _assert_fp32_matmul(am)
    # stability shifts only: the normalizer is shift-invariant
    am_max = am.amax(dim=2, keepdim=True).detach()
    lm_max = lm.amax(dim=2, keepdim=True).detach()
    am_probs = torch.exp(am - am_max)
    lm_probs = torch.exp(lm - lm_max)
    normalizers = torch.log(torch.einsum("bsc,btc->sbt", lm_probs.float(), am_probs.float()) + _TINY)
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
    # the am-only normalizer contracts into float32, as the JAX package's
    # preferred_element_type=float32 einsum does (bf16 exps stay bf16)
    amonly_norm = torch.log(torch.einsum("btc,c->bt", am_probs.float(), unigram.float()))[None]
    amonly_norm = amonly_norm + am_max_r
    uni_log = torch.log(unigram)
    lmonly_norm = torch.log(lmonly_norm).permute(1, 0, 2) + lm_max_r  # (S+1, B, 1)

    px_am, px_lm = _px_gathers(lm, am, symbols)
    # px_am is float32 in the JAX package (a one-hot contraction), so the
    # sums px_am + px_lm and px_am + px_uni are formed in float32
    px_am = px_am.float()
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
    # the lm-only terms stay in lm's dtype; a Python scale takes that dtype
    # first, as in JAX (a bf16 term times bf16(0.2), not float32 0.2)
    l = torch.tensor(l, dtype=px_lmonly.dtype)
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

    On a CUDA tensor the build runs the kernel of ``kernels/latbuild.py``;
    on a CPU tensor, or under ``set_lattice_build_impl("plain")``, the
    plain einsum build.
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
    or under ``set_lattice_build_impl("plain")``, the plain einsum build.
    """
    _check_rnnt_type(rnnt_type)
    if not _build_kernel_route(am):
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


def band_mask_rows(x: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """(B, S', T')-major :func:`band_mask_rows_smajor` with the band of
    ``ranges`` [B, T, K]: -inf outside ``ranges[b, t, 0] <= s <
    ranges[b, t, 0] + K``."""
    return band_mask_rows_smajor(x.movedim(1, 0), ranges[:, :, 0], ranges.shape[2]).movedim(0, 1)


def get_rnnt_logprobs(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    rnnt_type: str = "regular",
    boundary: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, T)-major :func:`get_rnnt_logprobs_rows`: px [B, S, T+1]
    (regular) or [B, S, T], py [B, S+1, T], as views of the s-major rows
    (the build kernel on a CUDA tensor)."""
    px, py = get_rnnt_logprobs_rows(lm, am, symbols, termination_symbol, rnnt_type, boundary)
    return px.movedim(0, 1), py.movedim(0, 1)


def get_rnnt_logprobs_smoothed(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    lm_only_scale: float = 0.1,
    am_only_scale: float = 0.1,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, T)-major :func:`get_rnnt_logprobs_smoothed_rows`."""
    px, py = get_rnnt_logprobs_smoothed_rows(
        lm, am, symbols, termination_symbol, lm_only_scale, am_only_scale, boundary, rnnt_type
    )
    return px.movedim(0, 1), py.movedim(0, 1)


def _pad_normalizers(normalizers: torch.Tensor, rnnt_type: str) -> torch.Tensor:
    """Width-match (B, S+1, T) normalizers to px: a zero column for the
    extra t = T position of regular px (where px is -inf)."""
    if rnnt_type == "regular":
        B, S1, _ = normalizers.shape
        return torch.cat([normalizers, normalizers.new_zeros((B, S1, 1))], dim=2)
    return normalizers


def _neg_inf_column(px: torch.Tensor) -> torch.Tensor:
    """Append the -inf t = T column of regular (B, S, T) px."""
    B, S, _ = px.shape
    return torch.cat([px, px.new_full((B, S, 1), NEG_INF)], dim=2)


def _finish(px, py, rnnt_type, boundary):
    """The rnnt_type tail of the B-major builders: regular kills each
    utterance's t_end column, constrained adds py of the next row."""
    if rnnt_type == "regular":
        return fix_for_boundary(px, boundary), py
    if rnnt_type == "constrained":
        return px + py[:, 1:, :], py
    return px, py


def get_rnnt_logprobs_joint(
    logits: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(px, py) from a full joiner output [B, T, S+1, C] (reference
    rnnt_loss.py:340-452): px [B, S, T(+1)] in at least float32, py
    [B, S+1, T] in the logits' dtype, as in the JAX package."""
    _check_rnnt_type(rnnt_type)
    B, T, S1, C = logits.shape
    S = S1 - 1
    normalizers = torch.logsumexp(logits, dim=3).transpose(1, 2)  # [B, S+1, T]
    sym, valid = _symbol_index(symbols, C)
    px = torch.gather(logits[:, :, :S, :], 3, sym[:, None, :, None].expand(B, T, S, 1))[..., 0]
    px = torch.where(valid[:, None, :], px, 0.0).transpose(1, 2)  # [B, S, T]
    px = px.to(torch.promote_types(px.dtype, torch.float32))
    if rnnt_type == "regular":
        px = _neg_inf_column(px)
    px = px - _pad_normalizers(normalizers, rnnt_type)[:, :S, :]
    py = logits[:, :, :, termination_symbol].transpose(1, 2) - normalizers
    return _finish(px, py, rnnt_type, boundary)


def roll_by_shifts(src: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Per-(b, t) circular right-roll of the last dim of [B, T, S] ``src``
    by ``shifts[b, t]`` (reference ``_roll_by_shifts``, rnnt_loss.py:814-851)."""
    B, T, S = src.shape
    idx = torch.arange(S, device=src.device)[None, None, :] - shifts[:, :, None].long()
    return torch.gather(src, 2, idx % S)


def scatter_window(
    win: torch.Tensor, shifts: torch.Tensor, out_width: int, fill: float = NEG_INF
) -> torch.Tensor:
    """Place each (b, t) window ``win[b, t, :]`` at offset ``shifts[b, t]``
    in a ``fill`` row of ``out_width``: ``out[b, t, shifts[b, t] + k] =
    win[b, t, k]``, ``fill`` elsewhere (the reference's pad-then-roll,
    rnnt_loss.py:967-1011, whenever ``shifts + K <= out_width``)."""
    B, T, K = win.shape
    j = torch.arange(out_width, device=win.device)[None, None, :]
    rel = j - shifts[:, :, None].long()
    out = win.new_full((B, T, out_width), fill)
    for k in range(K):
        out = torch.where(rel == k, win[:, :, k : k + 1], out)
    return out


def get_rnnt_logprobs_pruned(
    logits: torch.Tensor,
    symbols: torch.Tensor,
    ranges: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(px, py) from a pruned joiner output [B, T, s_range, C] (reference
    rnnt_loss.py:853-1020): a per-frame normalizer, the pruned symbols'
    logits, each frame's window placed back at its absolute symbol rows,
    -inf elsewhere.  px [B, S, T(+1)], py [B, S+1, T], in the logits'
    dtype."""
    _check_rnnt_type(rnnt_type)
    if rnnt_type == "constrained" and ranges.shape[2] < 2:
        # the constrained px adds py of the next symbol row at t+1; with a
        # width-1 window that row is outside the band, so every px arc is
        # -inf and every loss infinite
        raise ValueError("constrained RNN-T needs s_range >= 2")
    B, T, K, C = logits.shape
    S = symbols.shape[1]
    dev = logits.device
    sym_wt = torch.cat(
        [symbols.long(), torch.full((B, 1), int(termination_symbol), dtype=torch.long, device=dev)],
        dim=1,
    )  # [B, S+1]
    rg = ranges.long()
    rg_ok = (rg >= 0) & (rg <= S)
    pruned = torch.gather(sym_wt[:, None, :].expand(B, T, S + 1), 2, rg.clamp(0, S))
    pruned = torch.where(rg_ok, pruned, 0)  # [B, T, K]; a range outside [0, S] reads symbol 0
    psym, pvalid = _symbol_index(pruned, C)
    normalizers = torch.logsumexp(logits, dim=3)  # [B, T, K]
    px = torch.where(pvalid, torch.gather(logits, 3, psym[..., None])[..., 0], 0.0) - normalizers
    py_band = logits[:, :, :, termination_symbol] - normalizers
    lo = ranges[:, :, 0]
    px = scatter_window(px, lo, S + 1)[:, :, :S].transpose(1, 2)  # [B, S, T]
    if rnnt_type == "regular":
        px = _neg_inf_column(px)
    py = scatter_window(py_band, lo, S + 1).transpose(1, 2)  # [B, S+1, T]
    return _finish(px, py, rnnt_type, boundary)


def get_rnnt_logprobs_pruned_simple(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    ranges: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(px, py) of the pruned additive-joiner loss, built band-natively: the
    simple lattice masked to the band of ``ranges``, equal (fp32 round-off)
    to ``get_rnnt_logprobs_pruned(am_p + lm_p, ...)`` with ``am_p, lm_p =
    do_rnnt_pruning(am, lm, ranges)``, without the [B, T, K, C] logits."""
    _check_rnnt_type(rnnt_type)
    if rnnt_type == "constrained" and ranges.shape[2] < 2:
        raise ValueError("constrained RNN-T needs s_range >= 2")
    # the constrained add must come after the band masking, as in
    # get_rnnt_logprobs_pruned
    base_type = "modified" if rnnt_type == "constrained" else rnnt_type
    px, py = get_rnnt_logprobs(lm, am, symbols, termination_symbol, base_type, boundary)
    px, py = band_mask_rows(px, ranges), band_mask_rows(py, ranges)
    if rnnt_type == "constrained":
        px = px + py[:, 1:, :]
    return px, py
