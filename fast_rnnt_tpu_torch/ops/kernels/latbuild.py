"""Simple-lattice build (lm, am, symbols) -> s-major (px, py): wrapper of
the CUDA kernel in ``csrc/latbuild.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``fast_rnnt_tpu/ops/kernels/latbuild.py``
``_build_fwd_kernel(parts=False)`` (:207, entry ``lattice_rows_fused``
:713).  As there, the small lm-side precomputation (``_lm_parts``) is plain
tensor work outside the kernel, and the constrained variant is composed in
plain torch: build "modified", add ``py[1:]`` to px, cast last.

A CPU tensor runs the plain einsum build (``lattice._build_rows_plain``),
which is ordinary differentiable torch.  A CUDA tensor runs the kernel; the
kernel's backward (the build's VJP, ``_build_bwd_kernel`` in the JAX
package) is not ported yet, so differentiating the CUDA build raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..lattice import _build_rows_plain, _symbol_index
from . import _build

__all__ = ["lattice_rows", "lattice_rows_plain", "LAUNCHES"]

LAUNCHES = {"fwd": 0}

lattice_rows_plain = _build_rows_plain


def _lm_parts(lm: torch.Tensor, symbols: torch.Tensor, blank: int):
    """lm softmax parts and per-(b, s) gathers, B-major (the kernel's side
    inputs): lmmax (B, S+1), lmp (B, S+1, C), pxlm (B, S), pylm (B, S+1)."""
    lm32 = lm.float()
    lmmax = lm32.amax(dim=2).detach()
    lmp = torch.exp(lm32 - lmmax[:, :, None])
    S = symbols.shape[1]
    sym, valid = _symbol_index(symbols, lm.shape[2])
    pxlm = torch.where(valid, torch.gather(lm32[:, :S, :], 2, sym[:, :, None])[:, :, 0], 0.0)
    pylm = lm32[:, :, blank]
    return lmmax.contiguous(), lmp.contiguous(), pxlm.contiguous(), pylm.contiguous()


def _launch(lm, am, symbols, te_fix, blank: int, modified: bool):
    B, T, C = am.shape
    S = lm.shape[1] - 1
    dev = am.device
    for name, x in (("lm", lm), ("am", am)):
        if x.device != dev or x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {dev}, got {x.dtype} on {x.device}")
    if tuple(symbols.shape) != (B, S) or symbols.device != dev:
        raise ValueError(f"symbols {tuple(symbols.shape)} must be ({B}, {S}) on {dev}")
    if B > 65535:
        raise ValueError(f"B={B} exceeds the kernel grid's utterance axis (65535)")
    if not -C <= blank < C:
        raise IndexError(f"termination_symbol {blank} is out of range for C={C}")
    blank %= C  # a negative blank counts from the end, as am[:, :, blank] does
    am = am.contiguous()
    sym = symbols.to(torch.int32).contiguous()
    lmmax, lmp, pxlm, pylm = _lm_parts(lm, sym, blank)
    T1 = T if modified else T + 1
    px = torch.empty((S, B, T1), dtype=torch.float32, device=dev)
    py = torch.empty((S + 1, B, T), dtype=torch.float32, device=dev)
    if B == 0:
        return px, py
    lib = _build.load_library()
    err = lib.frt_latbuild_fwd(
        _build.ptr(lmp), _build.ptr(pxlm), _build.ptr(pylm), _build.ptr(lmmax),
        _build.ptr(sym), _build.ptr(te_fix), _build.ptr(am),
        B, S, T, C, int(blank), int(modified),
        _build.ptr(px), _build.ptr(py), _build.stream_ptr(dev),
    )
    _build.check(err, "latbuild_fwd")
    LAUNCHES["fwd"] += 1
    return px, py


class _BuildFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lm, am, symbols, te_fix, blank, modified):
        return _launch(lm, am, symbols, te_fix, blank, modified)

    @staticmethod
    def backward(ctx, dpx, dpy):
        raise NotImplementedError(
            "the gradient of the CUDA lattice build is not ported yet: it is "
            "the build's VJP kernel (fast_rnnt_tpu latbuild._build_bwd_kernel), "
            "first in ROADMAP.md Queue 2"
        )


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
    on a CUDA tensor, the plain einsum build on a CPU tensor."""
    if rnnt_type == "constrained":
        px, py = lattice_rows(lm, am, symbols, termination_symbol, "modified")
        px = px + py[1:]
    elif not am.is_cuda:
        px, py = lattice_rows_plain(lm, am, symbols, termination_symbol, rnnt_type, boundary)
    else:
        B = am.shape[0]
        if rnnt_type == "regular" and boundary is not None:
            te_fix = boundary[:, 3].to(device=am.device, dtype=torch.int32).contiguous()
        else:
            te_fix = torch.full((B,), -1, dtype=torch.int32, device=am.device)
        px, py = _BuildFn.apply(
            lm, am, symbols, te_fix, int(termination_symbol), rnnt_type == "modified"
        )
    if out_dtype is not None:
        px, py = px.to(out_dtype), py.to(out_dtype)
    return px, py
