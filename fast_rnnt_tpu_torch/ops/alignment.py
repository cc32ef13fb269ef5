"""Viterbi (best-path) scoring and forced alignment on the RNN-T lattice
(PyTorch port of ``fast_rnnt_tpu/ops/alignment.py``).

The same first-order row recurrence as the mutual-information forward
(``recursion.py``), in the (max, +) tropical semiring instead of
(logaddexp, +):

    v[b, s, t] = max(v[b, s-1, t(-1)] + px[b, s-1, t(-1)],
                     v[b, s, t-1]     + py[b, s, t-1])

Each row is solved by the doubling scan of ``numerics.log_linear_scan``
with ``max`` in place of ``logaddexp`` (max-plus linear recurrences
compose associatively); the S+1 rows run as a Python loop, as the JAX
``lax.scan`` does.  Plain PyTorch ops on either device: the JAX package
computes this in XLA, outside any Pallas kernel.  Both ops take
batch-sharded ``DTensor`` s and run per shard (``kernels/partition.py``).

The alignment falls out of autodiff: the gradient of ``max`` goes to its
argmax branch, so the gradient of ``viterbi_scores`` w.r.t. ``px`` is the
0/1 indicator of the best path's symbol arcs (``torch.maximum`` splits it
0.5/0.5 on an exact tie, as ``lax.max`` does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernels.partition import partitioned
from .numerics import NEG_INF, _shift_right
from .recursion import _mask_rows, _normalize_boundary

__all__ = ["viterbi_scores", "viterbi_alignment"]


def _max_linear_scan(coeff: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Solve ``x_t = max(coeff_t + x_{t-1}, bias_t)`` with ``x_{-1} = -inf``
    along the last axis: the tropical analogue of ``log_linear_scan``,
    whose combine ``(a1 + a2, max(b1 + a2, b2))`` it applies in
    ceil(log2 W) doubling rounds."""
    a, b = coeff, bias
    w = a.shape[-1]
    d = 1
    while d < w:
        b = torch.maximum(_shift_right(b, d, NEG_INF) + a, b)
        if 2 * d < w:  # the last round's coefficient update is dead
            a = _shift_right(a, d, 0.0) + a
        d *= 2
    return b


@partitioned({"px": 0, "py": 0, "boundary": 0}, 0)
def viterbi_scores(
    px: torch.Tensor,
    py: torch.Tensor,
    boundary: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Best single-path score through the lattice (the tropical analogue of
    ``mutual_information_recursion``, with the same px/py/boundary
    contract).  Differentiable: the gradient w.r.t. (px, py) is the 0/1
    best-path indicator."""
    B, S, T1 = px.shape
    T = py.shape[2]
    modified = T1 == T
    bnd = _normalize_boundary(boundary, B, S, T, device=px.device)
    px_rows, py_rows = _mask_rows(px.movedim(1, 0), py.movedim(1, 0), bnd, modified)

    sb, tb, se, te = (bnd[:, i].long() for i in range(4))
    t_iota = torch.arange(T + 1, device=px.device)
    source_t = t_iota[None, :] == tb[:, None]  # (B, T+1)
    neg_col = torch.full((B, 1), NEG_INF, dtype=py_rows.dtype, device=px.device)
    prev_v = torch.full((B, T + 1), NEG_INF, dtype=py_rows.dtype, device=px.device)
    best = torch.full((B,), NEG_INF, dtype=py_rows.dtype, device=px.device)
    for s in range(S + 1):
        if s == 0:
            a = torch.full_like(prev_v, NEG_INF)
        elif modified:
            a = torch.cat([neg_col, prev_v[:, :T] + px_rows[s - 1]], dim=1)
        else:
            a = prev_v + px_rows[s - 1]
        src = torch.where((sb == s)[:, None] & source_t, 0.0, NEG_INF).to(a.dtype)
        b = torch.maximum(a, src)
        coeff = torch.cat([neg_col, py_rows[s]], dim=1)
        prev_v = _max_linear_scan(coeff, b)
        # harvest v[s_end, t_end] when this row is the end row
        val = prev_v.gather(1, te[:, None])[:, 0]
        best = torch.where(se == s, val, best)
    return best


# the unwrapped body, for viterbi_alignment (its arguments already local)
_viterbi_scores = viterbi_scores.__wrapped__


@partitioned({"px": 0, "py": 0, "boundary": 0}, (0, 0, 0))
def viterbi_alignment(
    px: torch.Tensor,
    py: torch.Tensor,
    boundary: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forced alignment: per-symbol emission frames of the best path, from
    one forward and one backward pass (no backtracking loop).

    Returns (scores, emit_frames, px_indicator):
      scores [B]: best-path scores (== viterbi_scores).
      emit_frames int32 [B, S]: frame at which symbol s is emitted on the
        best path (-1 for symbols outside the utterance's boundary).
      px_indicator [B, S, T']: the 0/1 best-path symbol-arc indicator (the
        gradient of the scores w.r.t. px).
    """
    px_in = px.detach().requires_grad_(True)
    with torch.enable_grad():
        scores = _viterbi_scores(px_in, py.detach(), boundary)
        (px_ind,) = torch.autograd.grad(scores.sum(), px_in)
    t_iota = torch.arange(px.shape[2], device=px.device, dtype=px_ind.dtype)
    emitted = px_ind.sum(dim=2) > 0.5  # (B, S)
    emit_frames = torch.where(
        emitted,
        (px_ind * t_iota).sum(dim=2).to(torch.int32),
        torch.full_like(emitted, -1, dtype=torch.int32),
    )
    return scores.detach(), emit_frames, px_ind
