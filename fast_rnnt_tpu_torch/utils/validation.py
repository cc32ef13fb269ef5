"""Input validation for the loss API (counterpart of
``fast_rnnt_tpu/utils/validation.py``).

:func:`check_rnnt_inputs` checks shapes and dtypes only, so the losses call
it on every call.  :func:`checkify_rnnt_inputs` checks values, which
synchronises with the device: it is opt-in, and no loss path calls it."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["check_rnnt_inputs", "checkify_rnnt_inputs"]


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def check_rnnt_inputs(
    lm: Optional[torch.Tensor] = None,
    am: Optional[torch.Tensor] = None,
    logits: Optional[torch.Tensor] = None,
    symbols: Optional[torch.Tensor] = None,
    termination_symbol: Optional[int] = None,
    boundary: Optional[torch.Tensor] = None,
    ranges: Optional[torch.Tensor] = None,
) -> None:
    """Raise ValueError naming the offending shapes.  Pass whichever
    arguments the calling loss uses."""
    B = None

    def _batch(x, name):
        nonlocal B
        if B is None:
            B = x.shape[0]
        elif x.shape[0] != B:
            raise ValueError(f"{name} batch dim {x.shape[0]} != {B}")

    if lm is not None:
        if lm.dim() != 3:
            raise ValueError(f"lm must be [B, S+1, C], got {tuple(lm.shape)}")
        _batch(lm, "lm")
    if am is not None:
        if am.dim() != 3:
            raise ValueError(f"am must be [B, T, C], got {tuple(am.shape)}")
        _batch(am, "am")
        if lm is not None and lm.shape[2] != am.shape[2]:
            raise ValueError(f"lm/am vocab mismatch: {lm.shape[2]} vs {am.shape[2]}")
    if logits is not None:
        if logits.dim() != 4:
            raise ValueError(f"logits must be 4-D, got {tuple(logits.shape)}")
        _batch(logits, "logits")
    if symbols is not None:
        if symbols.dim() != 2:
            raise ValueError(f"symbols must be [B, S], got {tuple(symbols.shape)}")
        _batch(symbols, "symbols")
        if not _is_integer(symbols.dtype):
            raise ValueError(f"symbols must be integer, got {symbols.dtype}")
        if lm is not None and symbols.shape[1] != lm.shape[1] - 1:
            raise ValueError(
                f"symbols S={symbols.shape[1]} != lm S+1-1={lm.shape[1] - 1}"
            )
    if termination_symbol is not None:
        C = None
        for x in (lm, am):
            if x is not None:
                C = x.shape[2]
        if logits is not None:
            C = logits.shape[3]
        if C is not None and not (0 <= int(termination_symbol) < C):
            raise ValueError(
                f"termination_symbol {termination_symbol} out of range [0, {C})"
            )
    if boundary is not None:
        if boundary.dim() != 2 or boundary.shape[1] != 4:
            raise ValueError(f"boundary must be [B, 4], got {tuple(boundary.shape)}")
        _batch(boundary, "boundary")
        if not _is_integer(boundary.dtype):
            raise ValueError(f"boundary must be integer, got {boundary.dtype}")
    if ranges is not None:
        if ranges.dim() != 3:
            raise ValueError(f"ranges must be [B, T, s_range], got {tuple(ranges.shape)}")
        _batch(ranges, "ranges")


def checkify_rnnt_inputs(
    symbols: torch.Tensor,
    C: int,
    boundary: Optional[torch.Tensor] = None,
    S: Optional[int] = None,
    T: Optional[int] = None,
) -> None:
    """Value checks of the loss inputs (the JAX package's checkify checks,
    with the same messages): raise ValueError on the first that fails.
    Reads the values back to the host."""
    checks = [
        (symbols >= 0, "symbols must be >= 0"),
        (symbols < C, f"symbols must be < C={C}"),
    ]
    if boundary is not None:
        sb, tb, se, te = (boundary[:, i] for i in range(4))
        checks += [
            ((sb >= 0) & (tb >= 0), "begin must be >= 0"),
            (sb <= se, "s_begin must be <= s_end"),
            (tb <= te, "t_begin must be <= t_end"),
        ]
        if S is not None:
            checks.append((se <= S, f"s_end must be <= S={S}"))
        if T is not None:
            checks.append((te <= T, f"t_end must be <= T={T}"))
    for ok, msg in checks:
        if not bool(ok.all()):
            raise ValueError(msg)
