"""Mutual-information lattice recursion (PyTorch port of
``fast_rnnt_tpu/ops/recursion.py``): the s-major rows ops and the
(B, S, T)-major public ``mutual_information_recursion``.

    p[b, s_begin, t_begin] = 0
    regular:   p[b,s,t] = logadd(p[b,s-1,t]   + px[b,s-1,t],
                                 p[b,s,t-1]   + py[b,s,t-1])
    modified:  p[b,s,t] = logadd(p[b,s-1,t-1] + px[b,s-1,t-1],
                                 p[b,s,t-1]   + py[b,s,t-1])
    scores[b] = p[b, s_end, t_end]

Rows are (S, B, T)-major.  On a CUDA tensor they run the hand-written
diagonal-sweep kernel of ``kernels/wavefront.py``: its fused forward +
occupancy-backward launch where the occupancies are asked for
(``calc_gradients=True``), its forward phase alone for scores, and its
backward phase alone, seeded with the score gradient, on demand under
autograd; on a CPU tensor they run the plain versions below (S+1
sequential rows, each solved by a doubling scan over t, see
``numerics.py``).  :func:`set_default_impl`
picks that route for the recursion and the pruning ranges: ``"plain"``
runs the plain versions on any device (the parity gate's independent path
on the card), ``"cuda"`` requires the kernels, and a name given to
:func:`register_impl` runs that implementation.  Every public entry takes
the same choice per call (``impl=``), which wins over the process default
for that call, forward and VJP: the autograd context records the route the
forward ran, and the backward runs it.

Dtype policy (the JAX package's, ``recursion.py:468-495``): float32 runs
as it is; bfloat16 and float16 are storage, read and widened to float32 by
the kernels (the plain path promotes), with p and the scores float32 and
the occupancies returned in the storage dtype.  float64 on a CUDA tensor
raises TypeError and is never sent to the plain path; on the CPU every
float dtype runs the plain path.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .kernels.partition import current_shards, partitioned, within
from .numerics import NEG_INF, log_linear_scan, logaddexp, reverse_linear_scan, safe_exp

__all__ = [
    "mutual_information_recursion",
    "mutual_information_rows",
    "occupancy_roundtrip_check",
    "cummin",
    "monotonic_lower_bound",
    "register_impl",
    "set_default_impl",
]

# The route of the recursion and pruning-ranges wrappers (the JAX package's
# process default, fast_rnnt_tpu/ops/recursion.py:435): None, the kernels
# on a CUDA tensor and the plain versions on a CPU tensor; "cuda", the
# kernels (a CPU tensor raises); "plain", the plain versions on any device;
# or a name given to register_impl.
_IMPLS = ("cuda", "plain")
_DEFAULT_IMPL: Optional[str] = None
# register_impl's implementations: name -> (forward_fn, backward_fn)
_IMPL: Dict[str, Tuple[Callable, Callable]] = {}
# the JAX package's names, which the port rejects rather than map silently
_JAX_NAMES = {"xla": "plain", "pallas": "cuda"}


def _check_impl(impl: str) -> None:
    """ValueError unless ``impl`` is "cuda", "plain" or a registered name;
    the JAX package's "xla" and "pallas" name the port's counterparts."""
    if impl in _JAX_NAMES:
        raise ValueError(
            f"impl {impl!r} is the JAX package's name: the port's counterpart is "
            f"{_JAX_NAMES[impl]!r} (\"plain\": the plain versions, \"cuda\": the kernels)"
        )
    if impl not in _IMPLS and impl not in _IMPL:
        raise ValueError(f"unknown impl {impl!r}; one of {_IMPLS + tuple(_IMPL)}")


def set_default_impl(impl: Optional[str]) -> None:
    """Pin (``"cuda"``, ``"plain"`` or a :func:`register_impl` name) or
    reset (``None``) the route of the recursion and the pruning ranges for
    every later call that passes no ``impl=``, forward and VJP.  Nothing
    reroutes silently: ``"cuda"`` on a CPU tensor raises ValueError, and so
    does an unknown name or one of the JAX package's (``"xla"``, whose
    counterpart is ``"plain"``, and ``"pallas"``, whose is ``"cuda"``)."""
    global _DEFAULT_IMPL
    if impl is not None:
        _check_impl(impl)
    _DEFAULT_IMPL = impl


def register_impl(
    name: str, forward_fn: Callable, backward_fn: Callable, default: bool = False
) -> None:
    """Register an alternative recursion under ``name`` (the JAX package's
    contract, ``fast_rnnt_tpu/ops/recursion.py:391``): on (B, S, T)-major
    tensors, ``forward_fn(px, py, boundary) -> (residual, scores)`` and
    ``backward_fn(px, py, residual, boundary, ans_grad) -> (px_grad,
    py_grad)``.  The rows ops mask the pruning band into px and py before
    the call.  ``impl=name`` selects it per call; ``default=True`` makes it
    the process default.  With it the pruning ranges take the plain search,
    and the lattice build keeps its own route.  The built-in names
    ``"cuda"``, ``"plain"`` and ``"auto"`` (and the JAX package's ``"xla"``
    and ``"pallas"``) cannot be registered."""
    global _DEFAULT_IMPL
    if name in _IMPLS or name == "auto" or name in _JAX_NAMES:
        raise ValueError(f"impl name {name!r} is reserved")
    _IMPL[name] = (forward_fn, backward_fn)
    if default:
        _DEFAULT_IMPL = name


def _resolve_impl(impl: Optional[str]) -> Optional[str]:
    """A per-call ``impl``: None and "auto" give the process default (None:
    by the tensor's device), any other value is checked and wins."""
    if impl is None or impl == "auto":
        return _DEFAULT_IMPL
    _check_impl(impl)
    return impl


def _route(x: torch.Tensor, impl: Optional[str]) -> str:
    """The route a rows op runs for the per-call ``impl``: "cuda", "plain"
    or a registered name."""
    resolved = _resolve_impl(impl)
    if resolved == "cuda" and not x.is_cuda:
        raise ValueError(f'impl "cuda": a tensor on {x.device} has no kernel')
    return resolved or ("cuda" if x.is_cuda else "plain")


def _kernel_route(x: torch.Tensor, impl: Optional[str] = None) -> bool:
    """Whether the recursion and ranges wrappers launch their kernels on
    ``x`` for the per-call ``impl`` (see :func:`set_default_impl`); a
    registered implementation is not theirs, so they take the plain
    versions for it, as the JAX package's ranges do."""
    return _route(x, impl) == "cuda"


def _normalize_boundary(
    boundary: Optional[torch.Tensor], B: int, S: int, T: int, device=None
) -> torch.Tensor:
    """Default boundary [0, 0, S, T] per row; given boundaries are clamped
    to the lattice (s_end to [0, S], t_end to [0, T], begins to [0, end])."""
    if boundary is None:
        row = torch.tensor([0, 0, S, T], dtype=torch.int32, device=device)
        return row.expand(B, 4).contiguous()
    b = boundary.to(torch.int32)
    se = b[:, 2].clamp(0, S)
    te = b[:, 3].clamp(0, T)
    sb = torch.minimum(b[:, 0].clamp(min=0), se)
    tb = torch.minimum(b[:, 1].clamp(min=0), te)
    return torch.stack([sb, tb, se, te], dim=1)


def _promote_subf32(x: torch.Tensor) -> torch.Tensor:
    """The recursion computes in >= float32; narrower floats are storage."""
    if x.dtype.is_floating_point and torch.finfo(x.dtype).bits < 32:
        return x.float()
    return x


def _mask_rows(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    modified: bool,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-inf outside each utterance's boundary rectangle and, when ``lo`` is
    given, outside the pruning band ``lo[b, t] <= s < lo[b, t] + K`` (lo
    edge-padded for a regular px's extra t = T column)."""
    S, B, T1 = px_rows.shape
    T = py_rows.shape[2]
    dev = px_rows.device
    bnd = boundary.to(device=dev, dtype=torch.int32)
    sb = bnd[:, 0][None, :, None]
    tb = bnd[:, 1][None, :, None]
    se = bnd[:, 2][None, :, None]
    te = bnd[:, 3][None, :, None]

    s_px = torch.arange(S, dtype=torch.int32, device=dev)[:, None, None]
    t_px = torch.arange(T1, dtype=torch.int32, device=dev)[None, None, :]
    t_hi = te - 1 if modified else te
    px_ok = (s_px >= sb) & (s_px < se) & (t_px >= tb) & (t_px <= t_hi)

    s_py = torch.arange(S + 1, dtype=torch.int32, device=dev)[:, None, None]
    t_py = torch.arange(T, dtype=torch.int32, device=dev)[None, None, :]
    py_ok = (s_py >= sb) & (s_py <= se) & (t_py >= tb) & (t_py < te)

    if lo is not None:
        lo = lo.to(torch.int32)[None]  # (1, B, T)
        lo_px = lo if T1 == T else torch.cat([lo, lo[:, :, -1:]], dim=2)
        px_ok = px_ok & (s_px >= lo_px) & (s_px < lo_px + K)
        py_ok = py_ok & (s_py >= lo) & (s_py < lo + K)

    return (
        torch.where(px_ok, px_rows, NEG_INF),
        torch.where(py_ok, py_rows, NEG_INF),
    )


def _neg_col(B: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((B, 1), NEG_INF, dtype=like.dtype, device=like.device)


def _forward_row(s, prev, px_t, py_row, sb, source, modified, T):
    """One forward row: p[s, :] from p[s-1, :] (``prev``)."""
    B = py_row.shape[0]
    if s == 0:
        a = torch.full((B, T + 1), NEG_INF, dtype=py_row.dtype, device=py_row.device)
    elif modified:
        # a[t] = p[s-1, t-1] + px[s-1, t-1]
        a = torch.cat([_neg_col(B, py_row), prev[:, :T] + px_t[s - 1]], dim=1)
    else:
        # a[t] = p[s-1, t] + px[s-1, t]
        a = prev + px_t[s - 1]
    # inject the origin cell p[s_begin, t_begin] = 0
    src = torch.where((sb == s)[:, None] & source, 0.0, NEG_INF).to(a.dtype)
    b = logaddexp(a, src)
    # coeff[t] = py[s, t-1]; coeff[0] multiplies p[s, -1] = -inf (ignored)
    coeff = torch.cat([_neg_col(B, py_row), py_row], dim=1)
    return log_linear_scan(coeff, b)


def _forward_prologue(px_rows, py_rows, boundary, lo, K):
    S, B, T1 = px_rows.shape
    T = py_rows.shape[2]
    modified = T1 == T
    px_t, py_t = _mask_rows(px_rows, py_rows, boundary, modified, lo, K)
    px_t, py_t = _promote_subf32(px_t), _promote_subf32(py_t)
    bnd = boundary.to(device=py_t.device, dtype=torch.long)
    t_iota = torch.arange(T + 1, device=py_t.device)
    source = t_iota[None, :] == bnd[:, 1:2]  # (B, T+1) column of t_begin
    return S, B, T, modified, px_t, py_t, bnd, source


def _forward_rows_plain(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain s-major forward (port of ``_forward_rows_xla``): returns
    (p_rows [S+1, B, T+1], scores [B])."""
    S, B, T, modified, px_t, py_t, bnd, source = _forward_prologue(
        px_rows, py_rows, boundary, lo, K
    )
    rows = []
    prev = None
    for s in range(S + 1):
        prev = _forward_row(s, prev, px_t, py_t[s], bnd[:, 0], source, modified, T)
        rows.append(prev)
    p_rows = torch.stack(rows)
    scores = p_rows[bnd[:, 2], torch.arange(B, device=p_rows.device), bnd[:, 3]]
    return p_rows, scores


def _forward_scores_rows_plain(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
) -> torch.Tensor:
    """Scores-only forward (port of ``_forward_scores_rows_xla``): the
    score is harvested row by row, so the lattice is never stacked."""
    S, B, T, modified, px_t, py_t, bnd, source = _forward_prologue(
        px_rows, py_rows, boundary, lo, K
    )
    best = torch.full((B,), NEG_INF, dtype=py_t.dtype, device=py_t.device)
    prev = None
    for s in range(S + 1):
        prev = _forward_row(s, prev, px_t, py_t[s], bnd[:, 0], source, modified, T)
        val = prev.gather(1, bnd[:, 3:4])[:, 0]
        best = torch.where(bnd[:, 2] == s, val, best)
    return best


def _backward_rows_plain(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    p_rows: torch.Tensor,
    boundary: torch.Tensor,
    ans_grad: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    K: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain s-major occupancy backward (port of ``_backward_rows_xla``).

    With the score gradient seeded at (s_end, t_end):

        term1[s,t]   = safe_exp(p[s,t] + px[s,t] - p[s+1, t + dt])  (dt = 0|1)
        term2[s,t]   = safe_exp(p[s,t] + py[s,t] - p[s, t+1])
        g[s,t]       = g[s+1, t+dt] * term1[s,t] + g[s,t+1] * term2[s,t]
        px_grad[s,t] = g[s+1, t+dt] * term1[s,t]
        py_grad[s,t] = g[s, t+1]   * term2[s,t]

    Rows sweep s from S down to 0, each solved by a reverse linear scan.
    """
    S, B, T1 = px_rows.shape
    T = py_rows.shape[2]
    modified = T1 == T
    store_dt = px_rows.dtype
    px_t, py_t = _mask_rows(px_rows, py_rows, boundary, modified, lo, K)
    px_t, py_t = _promote_subf32(px_t), _promote_subf32(py_t)
    p_t = _promote_subf32(p_rows[:, :, : T + 1])
    dt, dev = p_t.dtype, p_t.device
    bnd = boundary.to(device=dev, dtype=torch.long)
    t_iota = torch.arange(T + 1, device=dev)
    seed_t = t_iota[None, :] == bnd[:, 3:4]
    ag = ans_grad.to(device=dev, dtype=dt)[:, None]
    zero_col = torch.zeros((B, 1), dtype=dt, device=dev)

    g_next = torch.zeros((B, T + 1), dtype=dt, device=dev)
    p_next = torch.zeros((B, T + 1), dtype=dt, device=dev)
    pxg = [None] * S
    pyg = [None] * (S + 1)
    for s in range(S, -1, -1):
        p_cur = p_t[s]
        if s < S:
            px_row = px_t[s]
        else:  # no arcs out of row S
            px_row = torch.full((B, T1), NEG_INF, dtype=dt, device=dev)
        if modified:
            term1 = safe_exp(p_cur[:, :T] + px_row - p_next[:, 1:])
            h_px = term1 * g_next[:, 1:]
            h = torch.cat([h_px, zero_col], dim=1)
        else:
            term1 = safe_exp(p_cur + px_row - p_next)
            h_px = term1 * g_next
            h = h_px
        seed = torch.where((bnd[:, 2] == s)[:, None] & seed_t, ag, 0.0)
        term2 = safe_exp(p_cur[:, :T] + py_t[s] - p_cur[:, 1:])
        g = reverse_linear_scan(torch.cat([term2, zero_col], dim=1), h + seed)
        pyg[s] = term2 * g[:, 1:]
        if s < S:
            pxg[s] = h_px
        g_next, p_next = g, p_cur
    px_grad = torch.stack(pxg) if S else torch.zeros((0, B, T1), dtype=dt, device=dev)
    return px_grad.to(store_dt), torch.stack(pyg).to(store_dt)


def _forward_lattice_plain(px, py, boundary):
    """The plain recursion in :func:`register_impl`'s interface, (B, S,
    T)-major: (residual = s-major p_rows, scores)."""
    return _forward_rows_plain(px.movedim(1, 0), py.movedim(1, 0), boundary)


def _backward_lattice_plain(px, py, p_rows, boundary, ans_grad):
    """The plain occupancy backward in :func:`register_impl`'s interface:
    (B, S, T)-major (px_grad, py_grad)."""
    gx, gy = _backward_rows_plain(px.movedim(1, 0), py.movedim(1, 0), p_rows, boundary, ans_grad)
    return gx.movedim(0, 1), gy.movedim(0, 1)


def _custom_args(px_rows, py_rows, boundary, lo, K):
    """A registered implementation's (B, S, T)-major px and py: the band
    masked in first (re-masking the boundary inside is idempotent)."""
    if lo is not None:
        px_rows, py_rows = _mask_rows(px_rows, py_rows, boundary, px_rows.shape[2] == py_rows.shape[2], lo, K)
    return px_rows.movedim(1, 0), py_rows.movedim(1, 0)


def _custom_backward(route, px_rows, py_rows, res, boundary, ans_grad, lo, K):
    """A registered implementation's backward, s-major occupancies."""
    px, py = _custom_args(px_rows, py_rows, boundary, lo, K)
    gx, gy = _IMPL[route][1](px, py, res, boundary, ans_grad)
    return gx.movedim(0, 1), gy.movedim(0, 1)


# The kernel wrappers below take the route positionally (``impl``, their
# last argument), so that a stand-in that passes ``*args`` on passes it too.


class _MIRowsWithGrads(torch.autograd.Function):
    """calc_gradients=True: occupancies (seed 1) are computed in forward, in
    one fused launch on the card (a registered implementation's forward,
    then its backward seeded with ones); since the backward recursion is
    linear in its seed, the backward only rescales them.  The occupancy
    outputs are not differentiable."""

    @staticmethod
    def forward(ctx, px_rows, py_rows, boundary, lo, K, route):
        from .kernels import wavefront

        if route in _IMPL:
            px, py = _custom_args(px_rows, py_rows, boundary, lo, K)
            res, scores = _IMPL[route][0](px, py, boundary)
            gx, gy = _custom_backward(route, px_rows, py_rows, res, boundary,
                                      torch.ones_like(scores), lo, K)
        else:
            scores, gx, gy = wavefront.fused_rows(px_rows, py_rows, boundary, lo, K, route)
        ctx.save_for_backward(gx, gy)
        ctx.mark_non_differentiable(gx, gy)
        return scores, gx, gy

    @staticmethod
    def backward(ctx, g_scores, _g_gx, _g_gy):
        gx, gy = ctx.saved_tensors
        scale = g_scores[None, :, None].to(gx.dtype)
        return scale * gx, scale * gy, None, None, None, None


class _MIRowsScores(torch.autograd.Function):
    """Scores only.  When a gradient is needed it saves p (or a registered
    implementation's residual) and runs the backward recursion, seeded with
    the incoming score gradient, on demand.  ``route`` is the forward's,
    and the backward runs it."""

    @staticmethod
    def forward(ctx, px_rows, py_rows, boundary, lo, K, route):
        needs_grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        ctx.route, ctx.K, ctx.shards = route, K, current_shards()
        if route in _IMPL:
            px, py = _custom_args(px_rows, py_rows, boundary, lo, K)
            res, scores = _IMPL[route][0](px, py, boundary)
            if needs_grad:
                ctx.res = res  # any residual a registered implementation keeps
                ctx.save_for_backward(px_rows, py_rows, boundary, lo)
            return scores
        if not needs_grad and route == "plain":
            return _forward_scores_rows_plain(px_rows, py_rows, boundary, lo, K)
        from .kernels import wavefront

        p_rows, scores = wavefront.forward_rows(px_rows, py_rows, boundary, lo, K, route)
        if needs_grad:
            ctx.save_for_backward(px_rows, py_rows, boundary, lo, p_rows)
        return scores

    @staticmethod
    def backward(ctx, g_scores):
        from .kernels import wavefront

        if ctx.route in _IMPL:
            px_rows, py_rows, boundary, lo = ctx.saved_tensors
            gx, gy = _custom_backward(ctx.route, px_rows, py_rows, ctx.res, boundary,
                                      g_scores.contiguous(), lo, ctx.K)
            return gx, gy, None, None, None, None
        px_rows, py_rows, boundary, lo, p_rows = ctx.saved_tensors
        with within(ctx.shards):
            gx, gy = wavefront.backward_rows(
                px_rows, py_rows, p_rows, boundary, g_scores.contiguous(), lo, ctx.K, ctx.route
            )
        return gx, gy, None, None, None, None


@partitioned({"px_rows": 1, "py_rows": 1, "boundary": 0, "lo": 0}, (0, (1, 1)))
def mutual_information_rows(
    px_rows: torch.Tensor,
    py_rows: torch.Tensor,
    boundary: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    s_range: int = 0,
    calc_gradients: bool = False,
    impl: Optional[str] = None,
):
    """s-major, optionally band-masked recursion.

    Args:
      px_rows: (S, B, T+1) regular or (S, B, T) modified/constrained.
      py_rows: (S+1, B, T).
      boundary: (B, 4) int rows [s_begin, t_begin, s_end, t_end], already
        normalized (see ``_normalize_boundary``).
      lo: optional (B, T) int window starts (``ranges[:, :, 0]``); with
        ``s_range`` the recursion sees the band-masked lattice without a
        masked copy being made.
      calc_gradients: also return the occupancies ``(px_grad, py_grad)``.
      impl: this call's route, forward and VJP: None or "auto" (the process
        default of :func:`set_default_impl`, then the tensor's device),
        "cuda", "plain" or a :func:`register_impl` name.

    Returns scores [B], or ``(scores, (px_grad, py_grad))``.
    """
    if lo is not None and int(s_range) <= 0:
        raise ValueError("banded recursion needs a positive static s_range")
    K = int(s_range)
    route = _route(px_rows, impl)
    if px_rows.dtype != py_rows.dtype:
        # one storage dtype for both (a joint lattice of bf16 logits has
        # float32 px and bf16 py); the occupancies come back in it
        dt = torch.promote_types(px_rows.dtype, py_rows.dtype)
        px_rows, py_rows = px_rows.to(dt), py_rows.to(dt)
    # the kernels take contiguous int32 (``lo`` is usually a strided slice
    # ``ranges[:, :, 0]``)
    boundary = boundary.to(torch.int32).contiguous()
    if lo is not None:
        lo = lo.to(torch.int32).contiguous()
    if calc_gradients:
        scores, gx, gy = _MIRowsWithGrads.apply(px_rows, py_rows, boundary, lo, K, route)
        return scores, (gx, gy)
    return _MIRowsScores.apply(px_rows, py_rows, boundary, lo, K, route)


@partitioned({"px_grad": 0, "py_grad": 0, "boundary": 0, "ans_grad": 0}, 0)
def occupancy_roundtrip_check(
    px_grad: torch.Tensor,
    py_grad: torch.Tensor,
    boundary: torch.Tensor,
    ans_grad: torch.Tensor,
) -> torch.Tensor:
    """Backward self-check: the total occupancy flowing out of the lattice
    origin must equal the seeded score cotangent.  For every cell the
    backward recursion has ``g[s, t] = px_grad[s, t] + py_grad[s, t] +
    seed[s, t]``, so at (s_begin, t_begin) the round trip ``g == ans_grad``
    holds when the backward is consistent with the forward.

    (B, S, T)-major occupancies; returns the per-utterance absolute error
    ``|g[sb, tb] - ans_grad|``."""
    B, S, _ = px_grad.shape
    T = py_grad.shape[2]
    dev = px_grad.device
    bidx = torch.arange(B, device=dev)
    bnd = boundary.to(device=dev, dtype=torch.long)
    sb, tb = bnd[:, 0], bnd[:, 1]
    at_end = (sb == bnd[:, 2]) & (tb == bnd[:, 3])
    ans_grad = ans_grad.to(dev)
    # rows/cols past the array edge contribute 0 (no such arc)
    px_part = (
        torch.where(sb < S, px_grad[bidx, sb.clamp(max=S - 1), tb], 0.0)
        if S else torch.zeros((B,), dtype=px_grad.dtype, device=dev)
    )
    py_part = (
        torch.where(tb < T, py_grad[bidx, sb, tb.clamp(max=T - 1)], 0.0)
        if T else torch.zeros((B,), dtype=py_grad.dtype, device=dev)
    )
    g0 = px_part + py_part + torch.where(at_end, ans_grad, 0.0)
    return (g0 - ans_grad).abs()


@partitioned({"px": 0, "py": 0, "boundary": 0}, 0)
def mutual_information_recursion(
    px: torch.Tensor,
    py: torch.Tensor,
    boundary: Optional[torch.Tensor] = None,
    calc_gradients: bool = False,
    impl: Optional[str] = None,
    debug_self_check: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]:
    """Mutual-information recursion between pairs of sequences, (B, S, T)-
    major (the JAX package's public API and argument order).

    Args:
      px: [B, S, T+1] (regular) or [B, S, T] (modified/constrained)
        log-prob increments for extending the symbol sequence.
      py: [B, S+1, T] log-prob increments for extending the frame sequence.
      boundary: optional int [B, 4] rows [s_begin, t_begin, s_end, t_end];
        defaults to [0, 0, S, T].
      calc_gradients: also return the occupancies ``(px_grad, py_grad)``,
        the gradients of ``scores.sum()`` w.r.t. (px, py), computed in the
        same pass and reused by autograd.  The occupancy outputs are not
        differentiable: only the scores propagate gradients.
      impl: this call's route, forward and VJP: None or "auto" (the process
        default of :func:`set_default_impl`, then the tensor's device),
        "cuda" (the kernels; a CPU tensor raises), "plain" (the plain
        versions on any device) or a :func:`register_impl` name.  The JAX
        package's "xla" and "pallas" raise ValueError.
      debug_self_check: verify that the occupancy backward round-trips the
        seed through the lattice origin and raise FloatingPointError if not.
        Costs a backward pass when ``calc_gradients`` is False and reads a
        value back to the host: a triage tool, not for hot loops.

    Returns scores [B] (float32 for float32 and narrower storage), or
    ``(scores, (px_grad, py_grad))`` if ``calc_gradients``.
    """
    B, S, T1 = px.shape
    T = py.shape[2]
    if tuple(py.shape) != (B, S + 1, T):
        raise ValueError(f"py shape {tuple(py.shape)} != ({B}, {S + 1}, {T})")
    if T1 not in (T, T + 1):
        raise ValueError(f"px last dim {T1} must be T={T} or T+1={T + 1}")
    if boundary is not None and tuple(boundary.shape) != (B, 4):
        raise ValueError(f"boundary shape {tuple(boundary.shape)} != ({B}, 4)")
    boundary = _normalize_boundary(boundary, B, S, T, device=px.device)
    px_rows = px.movedim(1, 0).contiguous()
    py_rows = py.movedim(1, 0).contiguous()
    if not (calc_gradients or debug_self_check):
        return mutual_information_rows(px_rows, py_rows, boundary, impl=impl)
    scores, (gx_rows, gy_rows) = mutual_information_rows(
        px_rows, py_rows, boundary, calc_gradients=True, impl=impl
    )
    px_grad, py_grad = gx_rows.movedim(0, 1), gy_rows.movedim(0, 1)
    if debug_self_check:
        err = occupancy_roundtrip_check(px_grad, py_grad, boundary, torch.ones_like(scores))
        # tolerance keyed on storage precision: f64+ tight; fp32 occupancies
        # of long lattices carry ~1e-3 of round-off; bf16/f16 storage the
        # loosest (the JAX package's bounds, recursion.py:862-867)
        bits = torch.finfo(px.dtype).bits
        tol = 1e-8 if bits > 32 else (1e-2 if bits == 32 else 1e-1)
        err = err.detach().float().cpu().numpy()
        bad = ~(err <= tol)  # catches NaN too
        if bad.any():
            raise FloatingPointError(
                "mutual_information_recursion debug_self_check failed: backward "
                f"round-trip error {err.max()} > tol {tol} for utterances "
                f"{np.nonzero(bad)[0].tolist()}: the occupancy backward is "
                "inconsistent with the forward (numerical overflow or an "
                "implementation bug)"
            )
    if calc_gradients:
        return scores, (px_grad, py_grad)
    return scores


def cummin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive running minimum along ``dim``."""
    return torch.cummin(x, dim=dim).values


def monotonic_lower_bound(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x_out[i] = min(x[i], x[i+1], ..., x[-1]) along ``dim`` (reverse
    cummin): a monotone non-decreasing lower bound."""
    return cummin(x.flip(dim), dim=dim).flip(dim)
