"""The pruned lattice, [B, T, K, C] joiner logits -> (px, py): wrapper of the
CUDA kernels in ``csrc/pruned_rows.cu`` and their plain PyTorch version.

Replaces no Pallas kernel: the JAX package's ``get_rnnt_logprobs_pruned``
is ``jnp``.  The kernels write the recursion's s-major rows, px_rows
[S, B, T(+1)] and py_rows [S+1, B, T], each element once, and the
backward writes d_logits in one pass; nothing of size [B, T, S+1] is kept
for it.  ``pruned_lattice`` returns them as (B, S, T)-major views, so the
recursion's ``.movedim(1, 0).contiguous()`` hands the kernel's own
storage on.

A CPU tensor runs the plain version, ordinary differentiable torch, and so
does any tensor under ``impl="plain"`` or ``lattice.set_lattice_build_impl(
"plain")``; a CUDA tensor launches the kernels or raises.  The kernels take
float32, bfloat16 or float16 logits and compute in float32: the normaliser
is rounded to the logits' dtype before the differences, which are rounded
too, as the plain version's arithmetic in that dtype rounds; its
log-sum-exp sums in another order than ``torch.logsumexp``, so float32
values may differ from the plain version's by a few ulps.  The -inf
pattern is the same.

``LAUNCHES`` counts each kernel's launches and ``FRAMES`` the B x T frames
of each forward the kernels built (``utils.profiling.counters`` names it
``pruned_lattice.kernel_frames``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..lattice import (
    _build_kernel_route,
    _finish,
    _neg_inf_column,
    _scatter_window,
    _symbol_index,
)
from . import _build
from .wavefront import _STORAGE  # storage dtype -> the kernels' dtype code

__all__ = ["pruned_lattice", "pruned_lattice_plain", "LAUNCHES", "FRAMES"]

LAUNCHES = {"band": 0, "rows": 0, "bwd": 0}
FRAMES = 0

_MODE = {"regular": 0, "modified": 1, "constrained": 2}
_INDEX = (torch.int32, torch.int64)


def pruned_lattice_plain(
    logits: torch.Tensor,
    symbols: torch.Tensor,
    ranges: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, T)-major px [B, S, T(+1)] and py [B, S+1, T] in the logits'
    dtype (reference rnnt_loss.py:853-1020): a per-frame normalizer, the
    pruned symbols' logits, each frame's window placed back at its absolute
    symbol rows, -inf elsewhere."""
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
    px = _scatter_window(px, lo, S + 1)[:, :, :S].transpose(1, 2)  # [B, S, T]
    if rnnt_type == "regular":
        px = _neg_inf_column(px)
    py = _scatter_window(py_band, lo, S + 1).transpose(1, 2)  # [B, S+1, T]
    return _finish(px, py, rnnt_type, boundary)


def pruned_lattice(
    logits: torch.Tensor,
    symbols: torch.Tensor,
    ranges: torch.Tensor,
    termination_symbol: int,
    boundary: Optional[torch.Tensor] = None,
    rnnt_type: str = "regular",
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, T)-major (px, py) of :func:`pruned_lattice_plain`: on the
    kernel route (``lattice._build_kernel_route``) views of the kernels'
    s-major rows, differentiable w.r.t. ``logits``."""
    if not _build_kernel_route(logits, impl):
        return pruned_lattice_plain(logits, symbols, ranges, termination_symbol, boundary, rnnt_type)
    C = logits.shape[3]
    if not -C <= termination_symbol < C:
        raise IndexError(f"termination_symbol {termination_symbol} out of range for C={C}")
    args = (symbols.contiguous(), ranges.contiguous(),
            None if boundary is None else boundary.contiguous())
    _check(logits, *args)
    px_rows, py_rows = _PrunedRowsFn.apply(logits.contiguous(), *args, int(termination_symbol),
                                           rnnt_type)
    return px_rows.movedim(0, 1), py_rows.movedim(0, 1)


def _check(logits, symbols, ranges, boundary) -> None:
    """Device, dtype and shape checks of the kernel route."""
    B, T, K, C = logits.shape
    dev = logits.device
    if not logits.is_cuda or logits.dtype not in _STORAGE:
        raise TypeError(f"the pruned-lattice kernels take float32, bfloat16 or float16 logits on a "
                        f"CUDA device, got {logits.dtype} on {dev}")
    for name, x, shape in (("symbols", symbols, (B, None)), ("ranges", ranges, (B, T, K)),
                           ("boundary", boundary, (B, 4))):
        if x is None:
            continue
        if x.device != dev or x.dtype not in _INDEX:
            raise TypeError(f"{name} must be an int32 or int64 tensor on {dev}, got {x.dtype} on "
                            f"{x.device}")
        if x.dim() != len(shape) or any(n is not None and x.shape[i] != n for i, n in enumerate(shape)):
            raise ValueError(f"{name} shape {tuple(x.shape)} does not fit logits {tuple(logits.shape)}")
    if B * T * K >= 2**31 or (symbols.shape[1] + 1) * B * (T + 1) >= 2**31:
        raise ValueError(f"logits {tuple(logits.shape)} with S={symbols.shape[1]} are too large for "
                         "the pruned-lattice kernels' 32-bit row counts")


def _vec(*xs: torch.Tensor) -> int:
    """The widest load of a row of C elements that every tensor allows: at
    most 16 bytes, C a multiple of it, each pointer aligned to it."""
    C, size = xs[0].shape[3], xs[0].element_size()
    v = 16 // size
    while v > 1 and (C % v or any(x.data_ptr() % (v * size) for x in xs)):
        v //= 2
    return v


def _is64(x: Optional[torch.Tensor]) -> int:
    return int(x is not None and x.dtype == torch.int64)


def _term_sym(termination_symbol: int, C: int) -> int:
    """The termination symbol as the pruned symbol of row S: itself in
    [0, C), else -1 (it reads 0, as an out-of-vocabulary symbol does)."""
    return termination_symbol if 0 <= termination_symbol < C else -1


class _PrunedRowsFn(torch.autograd.Function):
    """The CUDA pruned lattice: logits -> (px_rows, py_rows), its VJP a
    kernel too."""

    @staticmethod
    def forward(ctx, logits, symbols, ranges, boundary, termination_symbol, rnnt_type):
        global FRAMES
        B, T, K, C = logits.shape
        S = symbols.shape[1]
        T1 = T + 1 if rnnt_type == "regular" else T
        dev, dt = logits.device, logits.dtype
        px_band = torch.empty((B, T, K), dtype=dt, device=dev)
        py_band = torch.empty_like(px_band)
        lse = torch.empty((B, T, K), dtype=torch.float32, device=dev)
        px_rows = torch.empty((S, B, T1), dtype=dt, device=dev)
        py_rows = torch.empty((S + 1, B, T), dtype=dt, device=dev)
        lib = _build.load_library()
        p, stream = _build.ptr, _build.stream_ptr(dev)
        term_col = termination_symbol % C
        if B * T * K:
            err = lib.frt_pruned_band(
                p(logits), p(symbols), p(ranges), B, T, K, S, C,
                _term_sym(termination_symbol, C), term_col, _is64(symbols), _is64(ranges),
                _STORAGE[dt], _vec(logits), p(px_band), p(py_band), p(lse), stream,
            )
            _build.check(err, "pruned_band")
            LAUNCHES["band"] += 1
        if B * T1:
            err = lib.frt_pruned_rows(
                p(px_band), p(py_band), p(ranges), p(boundary), B, T, T1, K, S,
                _MODE[rnnt_type], _is64(ranges), _is64(boundary), _STORAGE[dt],
                p(px_rows), p(py_rows), stream,
            )
            _build.check(err, "pruned_rows")
            LAUNCHES["rows"] += 1
        FRAMES += B * T
        ctx.save_for_backward(logits, lse, symbols, ranges, boundary)
        ctx.termination_symbol, ctx.mode = termination_symbol, _MODE[rnnt_type]
        return px_rows, py_rows

    @staticmethod
    def backward(ctx, gpx, gpy):
        logits, lse, symbols, ranges, boundary = ctx.saved_tensors
        B, T, K, C = logits.shape
        S = symbols.shape[1]
        gpx, gpy = gpx.contiguous(), gpy.contiguous()  # s-major rows: no copy on the main path
        d_logits = torch.empty_like(logits)
        if d_logits.numel():
            term = ctx.termination_symbol
            p = _build.ptr
            err = _build.load_library().frt_pruned_bwd(
                p(logits), p(lse), p(gpx), p(gpy), p(symbols), p(ranges), p(boundary),
                B, T, gpx.shape[2], K, S, C, _term_sym(term, C), term % C, ctx.mode,
                _is64(symbols), _is64(ranges), _is64(boundary), _STORAGE[logits.dtype],
                _vec(logits, d_logits), p(d_logits), _build.stream_ptr(logits.device),
            )
            _build.check(err, "pruned_bwd")
            LAUNCHES["bwd"] += 1
        return d_logits, None, None, None, None, None
