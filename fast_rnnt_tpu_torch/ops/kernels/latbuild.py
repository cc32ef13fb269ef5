"""Simple and smoothed lattice builds, (lm, am, symbols) -> s-major rows,
and their backward: wrappers of the CUDA kernels in ``csrc/latbuild.cu``
(forward) and ``csrc/latbuild_bwd.cu`` (VJP), and their plain PyTorch
versions.

Replaces the Pallas TPU kernels ``fast_rnnt_tpu/ops/kernels/latbuild.py``
``_build_fwd_kernel`` (:207) and ``_build_bwd_kernel`` (:290), each with
``parts=False`` (entry ``lattice_rows_fused`` :713) and ``parts=True``
(entry ``lattice_rows_fused_smoothed`` :968).  As there, the unigram
statistics and the three-way interpolation of the smoothed lattice are
plain tensor work outside the kernels, and the constrained variant is
composed in plain torch: build "modified", add ``py[1:]`` to px.

A CPU tensor runs the plain versions, which are ordinary differentiable
torch, and so does any tensor under ``lattice.set_lattice_build_impl(
"plain")``.  A CUDA tensor runs the kernels: the forward writes the backward's
residuals (the normalizer denominator D, the frame maxima and, smoothed,
the unigram denominator) only when autograd needs a gradient, and the
backward launches the VJP kernels on them.

The kernels take float32 lm and am (products in 3xTF32 on the tensor
cores, see ``csrc/wgmma.cuh``), or bf16 lm and am (bf16 products, float32
sums), the JAX package's bf16 mode: px and py come out float32, the
gradients in the inputs' dtypes.  In that mode the backward keeps the
forward's float32 residual D (the JAX package recomputes it).  The plain
build rounds its bf16 exps as the JAX package's XLA build does,
bf16(exp(bf16(am - amax))); the smoothed build as its Pallas kernels do
(``_build_fwd_kernel`` / ``_build_bwd_kernel`` with ``parts=True``): the
exps taken in float32 and then rounded to bf16, the shifted gathers and
the unigram row rounded to bf16, and in the backward w, the px cotangent
of the one-hot term and the unigram weight of d_uni rounded to bf16.
``lattice_rows`` and ``lattice_rows_smoothed`` cast float16 lm and am to
float32 before the kernels, as the Pallas build contracts them
(``_mxu_dtype``); autograd carries the gradients back to float16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..lattice import (
    _TINY,
    _assert_fp32_matmul,
    _build_kernel_route,
    _build_rows_plain,
    _build_smoothed_rows_plain,
    _kill_t_end,
    _normalizers_plain,
    _pad_px,
    _px_gathers,
    _py_gathers,
    _smoothing_scales,
    _symbol_index,
)
from ..numerics import NEG_INF
from . import _build

__all__ = [
    "lattice_rows",
    "lattice_rows_plain",
    "lattice_rows_bwd_plain",
    "lattice_rows_parts_plain",
    "lattice_rows_smoothed",
    "lattice_rows_smoothed_plain",
    "build_fwd",
    "build_bwd",
    "LAUNCHES",
]

LAUNCHES = {"fwd": 0, "bwd": 0, "fwd_parts": 0, "bwd_parts": 0}

lattice_rows_plain = _build_rows_plain
lattice_rows_smoothed_plain = _build_smoothed_rows_plain

_KINDS = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=64)
def _scratch_sizes(B: int, S: int, T: int, C: int, bf16: bool, smoothed: bool):
    """Scratch of the build kernels, from ``frt_latbuild_sizes``: bytes of
    each part of the forward's lmp image, floats of wT, bytes of each part
    of the w and lmp^T images, the number P of row-sum partials."""
    out = (ctypes.c_longlong * 5)()
    _build.load_library().frt_latbuild_sizes(B, S, T, C, int(bf16), int(smoothed), out)
    return tuple(int(x) for x in out)


def _lm_probs(lm: torch.Tensor, smoothed: bool = False) -> torch.Tensor:
    """lmp = exp(lm - lmmax) (B, S+1, C) in lm's dtype, the backward's lm
    operand.  For bf16 lm, the plain build's in bf16 arithmetic, rounded as
    its forward's (and the JAX XLA build's) exps are; the smoothed build's
    taken in float32 and rounded once, as the Pallas build's are."""
    if smoothed:
        x = lm.float()
        return torch.exp(x - x.amax(dim=2, keepdim=True)).to(lm.dtype)
    return torch.exp(lm - lm.amax(dim=2, keepdim=True).detach())


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest bf16 value, kept in float32."""
    return x.bfloat16().float()


def _f16_as_f32(*xs):
    """float16 lm and am ride the float32 kernels; the others as they are."""
    return tuple(x.float() if x.dtype == torch.float16 else x for x in xs)


def _check_inputs(lm, am, symbols, te_fix, blank, uni=None):
    """Device, dtype and shape checks shared by both kernel wrappers;
    returns (B, S, T, C, blank wrapped into [0, C))."""
    B, T, C = am.shape
    S = lm.shape[1] - 1
    dev = am.device
    if am.dtype not in _KINDS or lm.dtype != am.dtype or lm.device != dev:
        raise TypeError(f"lm and am must both be float32 or both bfloat16 on {dev}, got "
                        f"{lm.dtype} on {lm.device} and {am.dtype}")
    if uni is not None and (uni.dtype != torch.float32 or uni.device != dev):
        raise TypeError(f"the smoothed build takes a float32 uni on {dev}")
    if tuple(lm.shape) != (B, S + 1, C):
        raise ValueError(f"lm {tuple(lm.shape)} must be ({B}, S+1, {C})")
    if tuple(symbols.shape) != (B, S) or symbols.device != dev:
        raise ValueError(f"symbols {tuple(symbols.shape)} must be ({B}, {S}) on {dev}")
    if tuple(te_fix.shape) != (B,) or te_fix.dtype != torch.int32 or te_fix.device != dev:
        raise ValueError(f"te_fix must be int32 ({B},) on {dev}")
    if uni is not None and tuple(uni.shape) != (C,):
        raise ValueError(f"uni {tuple(uni.shape)} must be ({C},)")
    if B > 65535:
        raise ValueError(f"B={B} exceeds the kernel grid's utterance axis (65535)")
    if not -C <= blank < C:
        raise IndexError(f"termination_symbol {blank} is out of range for C={C}")
    # a negative blank counts from the end, as am[:, :, blank] does
    return B, S, T, C, blank % C


def _check_cotangent(name, x, shape, dev):
    if x.device != dev or x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on {dev}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
    return x.contiguous()


def build_fwd(lm, am, symbols, te_fix, blank: int, modified: bool, uni=None, save: bool = False):
    """Launch the forward kernel.  Returns ``(px, py, nd, residuals)``:
    ``nd`` (S+1, B, T) only with ``uni`` (the smoothed build), else None;
    ``residuals`` = (D (S+1, B, T), amax (B, T), duni (B, T) or None) only
    with ``save``, else None."""
    B, S, T, C, blank = _check_inputs(lm, am, symbols, te_fix, blank, uni)
    dev = am.device
    am = am.contiguous()
    sym = symbols.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    px = torch.empty((S, B, T if modified else T + 1), **f32)
    py = torch.empty((S + 1, B, T), **f32)
    nd = torch.empty((S + 1, B, T), **f32) if uni is not None else None
    res = None
    if save:
        duni = torch.empty((B, T), **f32) if uni is not None else None
        res = (torch.empty((S + 1, B, T), **f32), torch.empty((B, T), **f32), duni)
    if B == 0:
        return px, py, nd, res
    d, amax, duni = res if save else (None, None, None)
    bf16 = am.dtype == torch.bfloat16
    lib = _build.load_library()
    p = _build.ptr
    # the lm side (lmmax, pylm, pxlm) and exp(lm - lmmax) as the products' B
    # operand, in the wgmma layout (csrc/wgmma.cuh), both made by the kernel
    nbytes = _scratch_sizes(B, S, T, C, bf16, False)[0]
    side = torch.empty(3 * B * (S + 1), **f32)
    img_hi = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    img_lo = None if bf16 else torch.empty_like(img_hi)
    err = lib.frt_latbuild_fwd(
        p(lm.contiguous()), p(sym), p(te_fix), p(am), p(None if uni is None else uni.contiguous()),
        B, S, T, C, int(blank), int(modified), int(bf16), p(side), p(img_hi), p(img_lo),
        p(px), p(py), p(nd), p(d), p(amax), p(duni), _build.stream_ptr(dev),
    )
    _build.check(err, "latbuild_fwd")
    LAUNCHES["fwd" if uni is None else "fwd_parts"] += 1
    return px, py, nd, res


def build_bwd(lm, am, symbols, te_fix, blank: int, modified: bool, residuals, dpx, dpy,
              uni=None, dnd=None):
    """Launch the VJP kernels on the forward's ``residuals``.  Returns
    ``(d_lm (B, S+1, C) float32, d_am (B, T, C) in am's dtype, d_uni (C,) or
    None)``: d_lm as the kernel sums it (the autograd route casts it to lm's
    dtype); ``uni`` and ``dnd`` together select the smoothed build's
    backward."""
    if (uni is None) != (dnd is None):
        raise ValueError("uni and dnd go together (the smoothed build's backward)")
    B, S, T, C, blank = _check_inputs(lm, am, symbols, te_fix, blank, uni)
    dev = am.device
    d, amax, duni = residuals
    dpx = _check_cotangent("dpx", dpx, (S, B, T if modified else T + 1), dev)
    dpy = _check_cotangent("dpy", dpy, (S + 1, B, T), dev)
    d = _check_cotangent("D", d, (S + 1, B, T), dev)
    amax = _check_cotangent("amax", amax, (B, T), dev)
    if uni is not None:
        dnd = _check_cotangent("dnd", dnd, (S + 1, B, T), dev)
        duni = _check_cotangent("duni", duni, (B, T), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = am.dtype == torch.bfloat16
    d_am = torch.empty((B, T, C), dtype=am.dtype, device=dev)
    d_lm = torch.empty((B, S + 1, C), **f32)
    d_uni_part = torch.zeros((B, C), **f32) if uni is not None else None
    if B == 0 or T == 0:
        d_lm.zero_()
    else:
        sym = symbols.to(torch.int32).contiguous()
        lmp = _lm_probs(lm, uni is not None)
        if uni is not None:  # the unigram row S+1 of both products, in lmp's dtype
            lmp = torch.cat([lmp, uni.to(lmp.dtype).expand(B, 1, C)], dim=1)
        lmp = lmp.contiguous()
        lib = _build.load_library()
        p = _build.ptr
        _, n_wT, w_bytes, l_bytes, P = _scratch_sizes(B, S, T, C, bf16, uni is not None)
        u8 = dict(dtype=torch.uint8, device=dev)
        wT = torch.empty(n_wT, **f32)
        wimg_hi, wimg_lo = torch.empty(w_bytes, **u8), torch.empty(w_bytes, **u8)
        limg_hi = torch.empty(l_bytes, **u8)
        limg_lo = None if bf16 else torch.empty(l_bytes, **u8)
        colsum = torch.empty((B, T), **f32)
        rsx = torch.empty((B, P, S + 1), **f32)
        rsy = torch.empty((B, P, S + 1), **f32)
        err = lib.frt_latbuild_bwd(
            p(lmp), p(sym), p(te_fix), p(am.contiguous()), p(amax), p(d), p(duni),
            p(dpx), p(dpy), p(dnd), B, S, T, C, int(blank), int(modified), int(bf16),
            p(wT), p(wimg_hi), p(wimg_lo), p(limg_hi), p(limg_lo), p(colsum), p(rsx), p(rsy),
            p(d_am), p(d_lm), p(d_uni_part), _build.stream_ptr(dev),
        )
        _build.check(err, "latbuild_bwd")
        LAUNCHES["bwd" if uni is None else "bwd_parts"] += 1
    return d_lm, d_am, None if uni is None else d_uni_part.sum(dim=0)


class _BuildFn(torch.autograd.Function):
    """The CUDA build: (lm, am) -> (px, py), its VJP a kernel too."""

    @staticmethod
    def forward(ctx, lm, am, symbols, te_fix, blank, modified):
        save = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        px, py, _, res = build_fwd(lm, am, symbols, te_fix, blank, modified, save=save)
        if save:
            ctx.save_for_backward(lm, am, symbols, te_fix, *res[:2])
            ctx.blank, ctx.modified = blank, modified
        return px, py

    @staticmethod
    def backward(ctx, dpx, dpy):
        lm, am, symbols, te_fix, d, amax = ctx.saved_tensors
        d_lm, d_am, _ = build_bwd(
            lm, am, symbols, te_fix, ctx.blank, ctx.modified, (d, amax, None), dpx, dpy
        )
        return d_lm.to(lm.dtype), d_am, None, None, None, None


class _BuildPartsFn(torch.autograd.Function):
    """The smoothed build: (lm, am, uni) -> (px, py, normd), its VJP the
    kernels' own: the CUDA kernels on the kernel route, their plain
    versions (``lattice_rows_parts_plain``, ``lattice_rows_bwd_plain``)
    otherwise; the backward takes the forward's route."""

    @staticmethod
    def forward(ctx, lm, am, symbols, te_fix, uni, blank, modified):
        save = any(ctx.needs_input_grad[i] for i in (0, 1, 4))
        ctx.kernel = _build_kernel_route(am)
        if ctx.kernel:
            px, py, nd, res = build_fwd(lm, am, symbols, te_fix, blank, modified, uni, save)
        else:
            (px, py, nd), res = lattice_rows_parts_plain(lm, am, symbols, te_fix, uni, blank, modified), ()
        if save:
            ctx.save_for_backward(lm, am, symbols, te_fix, uni, *res)
            ctx.blank, ctx.modified = blank, modified
        return px, py, nd

    @staticmethod
    def backward(ctx, dpx, dpy, dnd):
        lm, am, symbols, te_fix, uni, *res = ctx.saved_tensors
        if ctx.kernel:
            d_lm, d_am, d_uni = build_bwd(
                lm, am, symbols, te_fix, ctx.blank, ctx.modified, res, dpx, dpy, uni, dnd
            )
        else:
            d_lm, d_am, d_uni = lattice_rows_bwd_plain(
                lm, am, symbols, te_fix, dpx, dpy, ctx.blank, ctx.modified, uni, dnd
            )
        return d_lm.to(lm.dtype), d_am, None, None, d_uni, None, None


def _te_fix(boundary, B: int, regular: bool, device) -> torch.Tensor:
    """(B,) int32 t_end column that regular px kills; -1 kills nothing."""
    if regular and boundary is not None:
        return boundary[:, 3].to(device=device, dtype=torch.int32).contiguous()
    return torch.full((B,), -1, dtype=torch.int32, device=device)


def lattice_rows(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    rnnt_type: str = "regular",
    boundary: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """s-major ``(px_rows [S, B, T(+1)], py_rows [S+1, B, T])``; the kernel
    on a CUDA tensor, the plain einsum build on a CPU tensor or under
    ``set_lattice_build_impl("plain")``."""
    if rnnt_type == "constrained":
        px, py = lattice_rows(lm, am, symbols, termination_symbol, "modified")
        px = px + py[1:]
    elif not _build_kernel_route(am):
        px, py = lattice_rows_plain(lm, am, symbols, termination_symbol, rnnt_type, boundary)
    else:
        te_fix = _te_fix(boundary, am.shape[0], rnnt_type == "regular", am.device)
        px, py = _BuildFn.apply(
            *_f16_as_f32(lm, am), symbols, te_fix, int(termination_symbol), rnnt_type == "modified"
        )
    if out_dtype is not None:
        px, py = px.to(out_dtype), py.to(out_dtype)
    return px, py


def lattice_rows_parts_plain(lm, am, symbols, te_fix, uni, blank: int, modified: bool):
    """The plain version of the smoothed build kernel: (px, py, normd) with
    ``normd[s, t] = norm[s, t] - log sum_c uni[c] exp(am[t, c])``, float32;
    ordinary differentiable torch in (lm, am, uni).  bf16 lm and am are
    rounded where the Pallas smoothed build rounds them (``_parts_plain_bf16``);
    float16 lm and am are taken as float32, as that build takes them."""
    if am.dtype == torch.bfloat16:
        return _parts_plain_bf16(lm, am, symbols, te_fix, uni, blank, modified)
    lm, am = _f16_as_f32(lm, am)
    normalizers, am_max, am_probs, _, _ = _normalizers_plain(lm, am)
    px_am, px_lm = _px_gathers(lm, am, symbols)
    px = _pad_px(px_am + px_lm, modified) - _pad_px(normalizers[:-1], modified, 0.0)
    if not modified:
        px = _kill_t_end(px, te_fix)
    py = _py_gathers(lm, am, blank) - normalizers
    amonly = torch.log(torch.einsum("btc,c->bt", am_probs, uni)) + am_max[:, :, 0]
    return px, py, normalizers - amonly[None]


def _parts_plain_bf16(lm, am, symbols, te_fix, uni, blank: int, modified: bool):
    """The smoothed build on bf16 lm and am, as the Pallas parts kernel's
    bf16 mode computes it (``_build_fwd_kernel``,
    fast_rnnt_tpu/ops/kernels/latbuild.py:233-238, 279-288): the shift and
    the exps in float32, each exp and the unigram row rounded to bf16 (the
    products' operands, exact in float32), the shifted am gathers rounded to
    bf16, every sum float32; the am max cancels from normd."""
    _assert_fp32_matmul(am)
    a32, l32 = am.float(), lm.float()
    amax = a32.amax(dim=2, keepdim=True).detach()  # (B, T, 1)
    lmmax = l32.amax(dim=2, keepdim=True).detach()  # (B, S+1, 1)
    amp = _bf16_round(torch.exp(a32 - amax))
    lmp = _bf16_round(torch.exp(l32 - lmmax))
    lognorm = torch.log(torch.einsum("bsc,btc->sbt", lmp, amp) + _TINY) + lmmax.permute(1, 0, 2)
    amax_r = amax.permute(2, 0, 1)  # (1, B, T)
    px_am, px_lm = _px_gathers(l32, a32, symbols)
    px_am = _bf16_round(px_am - amax_r)
    px = _pad_px(px_am + px_lm, modified) - _pad_px(lognorm[:-1], modified, 0.0)
    if not modified:
        px = _kill_t_end(px, te_fix)
    py_am = _bf16_round(a32[:, :, blank][None] - amax_r)
    py = (py_am + l32[:, :, blank].t()[:, :, None]) - lognorm
    duni = torch.einsum("btc,c->bt", amp, _bf16_round(uni))
    return px, py, lognorm - torch.log(duni)[None]


def lattice_rows_bwd_plain(lm, am, symbols, te_fix, dpx, dpy, blank: int, modified: bool,
                           uni=None, dnd=None, d=None):
    """The plain version of the VJP kernels, the formulas of
    ``csrc/latbuild_bwd.cu`` written out: ``(d_lm, d_am, d_uni or None)``
    for cotangents (dpx, dpy) and, with the smoothed build's unigram row,
    ``uni`` and dnd; d_am in am's dtype, d_lm and d_uni float32.  For bf16
    lm and am the exps are the forward's bf16 values; the plain build takes
    everything after them in float32, the kernels' contract, and the
    smoothed build rounds as the Pallas parts kernel's bf16 mode does
    (``_build_bwd_kernel``, fast_rnnt_tpu/ops/kernels/latbuild.py:326-420):
    w, the one-hot term's px cotangent and d_uni's weight rd to bf16, the
    unigram row to bf16, and d_am's exp factor in float32.  float16 lm and
    am are taken as float32.  ``d``, the forward's residual D (S+1, B, T)
    as the kernels take it, replaces the recomputed normalizer denominator
    (the smoothed build's bf16 w then rounds from the same float32 value
    as in the kernels)."""
    _assert_fp32_matmul(am)
    B, T, C = am.shape
    S = symbols.shape[1]
    blank %= C
    pallas = uni is not None and am.dtype == torch.bfloat16
    rnd = _bf16_round if pallas else (lambda x: x)

    def shifted_exp(x):
        if pallas:
            x = x.detach().float()
            return _bf16_round(torch.exp(x - x.amax(dim=2, keepdim=True)))
        x = x.detach() if x.dtype == torch.bfloat16 else x.detach().float()
        return torch.exp(x - x.amax(dim=2, keepdim=True)).float()

    lmp, amp = shifted_exp(lm), shifted_exp(am)
    amp_f = amp
    if pallas:  # d_am's exp factor: the Pallas smoothed build's is float32, unrounded
        amf = am.detach().float()
        amp_f = torch.exp(amf - amf.amax(dim=2, keepdim=True))
    if d is None:
        d = torch.einsum("bsc,btc->bst", lmp, amp) + _TINY
    else:
        d = d.float().permute(1, 0, 2)
    # cotangents B-major; dpx zeroed on the constant -inf columns
    gx = dpx.float().permute(1, 0, 2)[:, :, :T]
    if not modified:
        t = torch.arange(T, device=am.device)[None, None, :]
        gx = torch.where(t == te_fix.to(am.device)[:, None, None], 0.0, gx)
    gy = dpy.float().permute(1, 0, 2)
    dnorm = -(torch.cat([gx, gx.new_zeros((B, 1, T))], dim=1) + gy)
    if dnd is not None:
        gnd = dnd.float().permute(1, 0, 2)
        dnorm = dnorm + gnd
    w = rnd(dnorm / d)  # (B, S+1, T)
    d_am = amp_f * torch.einsum("bst,bsc->btc", w, lmp)
    d_lm = lmp * torch.einsum("bst,btc->bsc", w, amp)
    sym, valid = _symbol_index(symbols, C)
    gxv = torch.where(valid[:, :, None], gx, 0.0)
    d_am = d_am.scatter_add(2, sym[:, None, :].expand(B, T, S), rnd(gxv).transpose(1, 2))
    d_am[:, :, blank] += gy.sum(dim=1)
    d_lm[:, :S] = d_lm[:, :S].scatter_add(2, sym[:, :, None], gxv.sum(dim=2, keepdim=True))
    d_lm[:, :, blank] += gy.sum(dim=2)
    d_uni = None
    if uni is not None:
        u = rnd(uni.detach().float())
        rd = -gnd.sum(dim=1) / torch.einsum("btc,c->bt", amp, u)
        d_am = d_am + amp_f * (rd[:, :, None] * u)
        d_uni = torch.einsum("bt,btc->c", rnd(rd), amp)
    return d_lm, d_am.to(am.dtype), d_uni


def lattice_rows_smoothed(
    lm: torch.Tensor,
    am: torch.Tensor,
    symbols: torch.Tensor,
    termination_symbol: int,
    lm_only_scale: float = 0.1,
    am_only_scale: float = 0.1,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smoothed s-major rows (port of ``lattice_rows_fused_smoothed``): the
    smoothed build kernels return (px, py, normd) and its VJP on a CUDA
    tensor (their plain versions on a CPU tensor); the unigram statistics
    and the three-way interpolation are plain torch, differentiable end to
    end."""
    if rnnt_type == "constrained":
        px, py = lattice_rows_smoothed(
            lm, am, symbols, termination_symbol, lm_only_scale, am_only_scale, None, "modified"
        )
        return px + py[1:], py
    B, T, C = am.shape
    S = lm.shape[1] - 1
    modified = rnnt_type == "modified"
    blank = int(termination_symbol)
    te_fix = _te_fix(boundary, B, not modified, am.device)
    lm32 = lm.float()
    lmmax = lm32.amax(dim=2).detach()
    lmp = torch.exp(lm32 - lmmax[:, :, None])
    lmsum = lmp.sum(dim=2)  # (B, S+1)
    # unigram LM: mean of the normalized lm probs over (B, S+1), padding
    # included, as the reference does
    uni = (lmp / lmsum[:, :, None]).mean(dim=(0, 1)) + _TINY
    uni_log = torch.log(uni)
    px, py, normd = _BuildPartsFn.apply(*_f16_as_f32(lm, am), symbols, te_fix, uni, blank, modified)

    # per-(b, s) columns, s-major (S?, B, 1)
    sym, valid = _symbol_index(symbols, C)
    pxlm = torch.where(valid, torch.gather(lm32[:, :S], 2, sym[:, :, None])[:, :, 0], 0.0)
    pxlm = pxlm.t()[:, :, None]
    pylm = lm32[:, :, blank].t()[:, :, None]
    lmonly = (torch.log(lmsum) + lmmax).t()[:, :, None]
    px_uni = torch.where(valid, uni_log[sym], 0.0).t()[:, :, None]
    py_uni = uni_log[blank]

    c, l, a = _smoothing_scales(lm_only_scale, am_only_scale)
    # px_amonly = px + normd + px_uni - pxlm ; px_lmonly = pxlm - lmonly
    nd_px = _pad_px(normd[:S], modified, 0.0)
    px_i = (c + a) * px + l * (pxlm - lmonly[:S]) + a * (nd_px + px_uni - pxlm)
    py_i = (c + a) * py + l * (pylm - lmonly) + a * (normd + py_uni - pylm)
    if not modified:
        # re-kill the -inf columns after the interpolation, so that no
        # cotangent flows through any term there (values are unchanged)
        t = torch.arange(T + 1, device=am.device)[None, None, :]
        kill = (t == T) | (t == te_fix[None, :, None])
        px_i = torch.where(kill, NEG_INF, px_i)
    return px_i, py_i
