"""Log-space / linear-recurrence numerics for the RNN-T lattice recursion.

PyTorch counterpart of ``fast_rnnt_tpu/ops/numerics.py``.  For a fixed
lattice row ``s`` the recursion

    p[s, t] = logaddexp(a[t], p[s, t-1] + c[t-1])

is a first-order linear recurrence over ``t`` in the (logaddexp, +)
log-semiring.  The elements ``(A_t, b_t)`` of ``x_t = (A_t (x) x_{t-1}) (+)
b_t`` compose associatively,

    (A1, b1) then (A2, b2)  ==  (A1 (x) A2,  (b1 (x) A2) (+) b2),

so a row is solved by a doubling (Hillis-Steele) scan over the last axis:
ceil(log2 W) rounds of whole-tensor ops, never a Python loop over ``t``.
The backward recursion has the same structure in ordinary (+, *) algebra.

Numerical contract (same as the JAX package):
  * ``logaddexp`` is -inf-safe: ``logaddexp(-inf, -inf) == -inf``.
  * ``safe_exp`` maps inf/NaN results (and NaN inputs) to 0.
"""

from __future__ import annotations

import torch

__all__ = [
    "NEG_INF",
    "logaddexp",
    "safe_exp",
    "log_linear_scan",
    "linear_scan",
    "reverse_linear_scan",
]

NEG_INF = float("-inf")


def logaddexp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """-inf/NaN-safe ``log(exp(x) + exp(y))``: the max is returned when
    ``x - y`` is NaN, so two -inf inputs give -inf, not NaN."""
    amax = torch.maximum(x, y)
    out = amax + torch.log1p(torch.exp(-torch.abs(x - y)))
    return torch.where(amax == NEG_INF, amax, out)


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) with the arguments whose exp overflows float32 (x > 88.6) or
    is NaN mapped to 0."""
    bad = torch.isnan(x) | (x > 88.6)
    return torch.where(bad, torch.zeros_like(x), torch.exp(torch.where(bad, 0.0, x)))


def _shift_right(x: torch.Tensor, d: int, fill: float) -> torch.Tensor:
    """x shifted d places to higher indices along the last axis."""
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def log_linear_scan(coeff: torch.Tensor, bias: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Solve ``x_t = logaddexp(coeff_t + x_{t-1}, bias_t)`` with
    ``x_{-1} = -inf`` along ``dim``.  ``coeff[..., 0]`` is ignored."""
    a = coeff.movedim(dim, -1)
    b = bias.movedim(dim, -1)
    w = a.shape[-1]
    d = 1
    while d < w:
        b = logaddexp(_shift_right(b, d, NEG_INF) + a, b)
        if 2 * d < w:  # the last round's coefficient update is dead
            a = _shift_right(a, d, 0.0) + a
        d *= 2
    return b.movedim(-1, dim)


def linear_scan(coeff: torch.Tensor, bias: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Solve ``x_t = coeff_t * x_{t-1} + bias_t`` with ``x_{-1} = 0``."""
    a = coeff.movedim(dim, -1)
    b = bias.movedim(dim, -1)
    w = a.shape[-1]
    d = 1
    while d < w:
        b = _shift_right(b, d, 0.0) * a + b
        if 2 * d < w:
            a = _shift_right(a, d, 1.0) * a
        d *= 2
    return b.movedim(-1, dim)


def reverse_linear_scan(coeff: torch.Tensor, bias: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Solve ``x_t = coeff_t * x_{t+1} + bias_t`` with ``x_T = 0``: the
    occupancy recursion, which flows right to left along the frame axis."""
    x = linear_scan(coeff.flip(dim), bias.flip(dim), dim=dim)
    return x.flip(dim)
