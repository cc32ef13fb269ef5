"""Plain reference of the pruned RNN-T loss, written from its definition.

Everything here is plain PyTorch, computed in the dtype of its inputs
(the benchmark passes float64), and differentiable by autograd.  It shares
no code with the measured program:

  * the lattice of the additive joiner (simple), of the smoothed joiner and
    of a pruned joiner output, each as full (px [B, S, T+1], py [B, S+1, T])
    with -inf cells replaced by ``NEG`` so that autograd stays finite;
  * the recursion p[s, t] = logaddexp(p[s-1, t] + px[s-1, t],
    p[s, t-1] + py[s, t-1]), p[0, 0] = 0, swept row by row for the whole
    batch at once, each row's blank arcs summed by a logcumsumexp; an
    utterance's score is p[s_end, t_end];
  * the pruning ranges from occupancies: per frame the s_range-wide window
    of largest score, boundary padding, the monotone and step-bounded
    repair (Pruned RNN-T paper, arXiv:2206.13236, section 3.2).

Only the regular RNN-T topology is defined: it is the one the benchmark's
configurations state.
"""

from __future__ import annotations

import torch

# a finite stand-in for -inf: logaddexp of two such cells is finite, so its
# gradient is 0 and not NaN
NEG = -1.0e30


def _kill_t_end(px: torch.Tensor, t_end: torch.Tensor) -> torch.Tensor:
    """No symbol is emitted on an utterance's one-past-the-end frame t_end,
    nor on the padding column T."""
    t = torch.arange(px.shape[2], device=px.device)[None, None, :]
    kill = (t == t_end[:, None, None]) | (t == px.shape[2] - 1)
    return torch.where(kill, torch.full_like(px, NEG), px)


def simple_lattice(lm, am, symbols, blank, boundary):
    """Lattice of the additive joiner: log_softmax(lm[s] + am[t]) at
    symbols[s] (px) and at the blank (py)."""
    B, S1, C = lm.shape
    T = am.shape[1]
    lm_max = lm.amax(2, keepdim=True).detach()
    am_max = am.amax(2, keepdim=True).detach()
    norm = torch.log(torch.bmm(torch.exp(lm - lm_max), torch.exp(am - am_max).transpose(1, 2)))
    norm = norm + lm_max + am_max.transpose(1, 2)  # [B, S+1, T]
    sym = symbols.long()
    px_am = torch.gather(am, 2, sym[:, None, :].expand(B, T, S1 - 1)).transpose(1, 2)
    px_lm = torch.gather(lm[:, :-1], 2, sym[:, :, None])
    px = px_am + px_lm - norm[:, :-1]
    px = torch.cat([px, px.new_full((B, S1 - 1, 1), NEG)], dim=2)
    py = am[:, :, blank][:, None, :] + lm[:, :, blank][:, :, None] - norm
    return _kill_t_end(px, boundary[:, 3].long()), py


def smoothed_lattice(lm, am, symbols, blank, lm_only_scale, am_only_scale, boundary):
    """Lattice of the smoothed joiner: the combined lattice times (1 - l - a),
    plus the lm-only lattice log_softmax(lm[s]) times l, plus the am-only
    lattice times a, whose LM is the unigram mean over (B, S+1) of
    softmax(lm), padding rows included.  A scale of exactly 0 counts as
    1e-20."""
    px, py = simple_lattice(lm, am, symbols, blank, boundary)
    B, S1, C = lm.shape
    sym = symbols.long()
    lm_logp = torch.log_softmax(lm, dim=2)
    unigram = torch.softmax(lm, dim=2).mean(dim=(0, 1))
    uni_log = torch.log(unigram)
    am_logp = torch.log_softmax(am + uni_log, dim=2)  # [B, T, C]
    px_lm = torch.gather(lm_logp[:, :-1], 2, sym[:, :, None])  # [B, S, 1]
    px_am = torch.gather(am_logp, 2, sym[:, None, :].expand(B, am.shape[1], S1 - 1)).transpose(1, 2)
    px_am = torch.cat([px_am, px_am.new_zeros((B, S1 - 1, 1))], dim=2)
    py_lm = lm_logp[:, :, blank][:, :, None]
    py_am = am_logp[:, :, blank][:, None, :]
    c, l, a = (1.0 - lm_only_scale - am_only_scale, lm_only_scale, am_only_scale)
    c, l, a = (1.0e-20 if x == 0.0 else x for x in (c, l, a))
    px = px * c + px_lm * l + px_am * a
    py = py * c + py_lm * l + py_am * a
    return _kill_t_end(px, boundary[:, 3].long()), py


def pruned_lattice(logits, symbols, ranges, blank, boundary):
    """Lattice of a pruned joiner output ``logits`` [B, T, K, C]: the cell
    (s, t) with s = ranges[b, t, k] takes log_softmax(logits[b, t, k]) at
    symbols[s] (px, for s < S) and at the blank (py); every other cell is
    NEG."""
    B, T, K, C = logits.shape
    S = symbols.shape[1]
    logp = torch.log_softmax(logits, dim=3)
    rg = ranges.long()
    sym_ext = torch.cat([symbols.long(), symbols.new_zeros((B, 1)).long()], dim=1)  # [B, S+1]
    sym_k = torch.gather(sym_ext[:, None, :].expand(B, T, S + 1), 2, rg.clamp(0, S))
    px_k = torch.gather(logp, 3, sym_k[..., None])[..., 0]  # [B, T, K]
    py_k = logp[..., blank]
    px = logits.new_full((B, S + 2, T + 1), NEG)
    py = logits.new_full((B, S + 2, T), NEG)
    rows = torch.where((rg >= 0) & (rg <= S), rg, S + 1)  # out-of-range rows land in a spare row
    t_idx = torch.arange(T, device=logits.device)[None, :, None].expand(B, T, K)
    b_idx = torch.arange(B, device=logits.device)[:, None, None].expand(B, T, K)
    px = px.index_put((b_idx, rows, t_idx), px_k)
    py = py.index_put((b_idx, rows, t_idx), py_k)
    px = px[:, :S]  # row S of px does not exist: no symbol after the last
    return _kill_t_end(px, boundary[:, 3].long()), py[:, : S + 1]


def band_lattice(px, py, ranges):
    """The cells of (px, py) inside each frame's window ranges[b, t, :];
    NEG elsewhere.  For the additive joiner this is the pruned lattice of
    ``am_pruned + lm_pruned``: its cells are the simple lattice's."""
    B, S, T1 = px.shape
    T = T1 - 1
    keep = torch.zeros((B, S + 2, T), dtype=torch.bool, device=px.device)
    rows = torch.where((ranges >= 0) & (ranges <= S), ranges.long(), S + 1)
    keep[torch.arange(B, device=px.device)[:, None, None],
         rows, torch.arange(T, device=px.device)[None, :, None]] = True
    px_b = torch.where(keep[:, :S], px[:, :, :T], torch.full_like(px[:, :, :T], NEG))
    px_b = torch.cat([px_b, px[:, :, T:]], dim=2)  # column T is NEG already
    py_b = torch.where(keep[:, : S + 1], py, torch.full_like(py, NEG))
    return px_b, py_b


def recursion(px, py, boundary):
    """Scores p[s_end, t_end] [B] of the lattice (px [B, S, T+1], py [B,
    S+1, T]); differentiable, so the gradient of the scores' sum w.r.t.
    (px, py) is the lattice's occupancies.

    Row by row: with A[t] = p[s-1, t] + px[s-1, t] the arcs into row s and
    c[t] the sum of py[s, :t], a row's blank arcs chain its cells, so
    p[s, t] = c[t] + logcumsumexp(A - c)[t] over the frames from the first
    whose blank arc is kept (not NEG) to one past the last.  A cell outside
    that run takes A[t] alone.  Each row's kept blank arcs have to be one
    run of frames, as a lattice's or a band's of monotone windows are; a
    row with two runs makes its utterance's score NaN."""
    B, S, T1 = px.shape
    T = T1 - 1
    dev = px.device
    kept = py > NEG / 2  # [B, S+1, T]
    n = kept.sum(2)
    t = torch.arange(T, device=dev)
    first = torch.where(kept, t, T).amin(2)  # T where the row keeps none
    last = torch.where(kept, t, -1).amax(2)
    one_run = (n == 0) | (last - first + 1 == n)  # [B, S+1]
    c = torch.cumsum(torch.where(kept, py, torch.zeros_like(py)), dim=2)
    c = torch.cat([py.new_zeros((B, S + 1, 1)), c], dim=2)  # [B, S+1, T+1]
    tt = torch.arange(T + 1, device=dev)[None, :]
    # p[0, 0] = 0 is row 0's one arc in
    a = torch.where(tt == 0, torch.zeros_like(c[:, 0]), torch.full_like(c[:, 0], NEG))
    # one unbind each, so that autograd gathers the rows' gradients in one
    # stack and not in a full-size tensor a row
    px_rows, c_rows = px.unbind(1), c.unbind(1)
    first_rows, last_rows = first.unbind(1), last.unbind(1)
    rows = []
    for s in range(S + 1):
        if s > 0:
            a = rows[-1] + px_rows[s - 1]
        lo, hi = first_rows[s][:, None], last_rows[s][:, None] + 1
        run = (tt >= lo) & (tt <= hi)
        chained = c_rows[s] + torch.logcumsumexp(
            torch.where(tt >= lo, a - c_rows[s], torch.full_like(a, NEG)), dim=1)
        rows.append(torch.where(run, chained, a))
    p = torch.stack(rows, dim=1)  # [B, S+1, T+1]
    s_end = boundary[:, 2].long()
    t_end = boundary[:, 3].long()
    score = p[torch.arange(B, device=dev), s_end, t_end]
    if S == 0:  # px is empty: keep it in the graph, its gradient empty
        score = score + px.sum()
    return torch.where(one_run.all(1), score, torch.full_like(score, float("nan")))


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    """y[t] = min over t' >= t of x[t'] along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, [-1]), dim=-1).values, [-1])


def window_scores(gx, gy, s_range):
    """[B, T, S+2-s_range] score of each window start k per frame: the sum
    of the blank occupancies gy[k : k+s_range] minus the symbol occupancy
    gx[k-1] that enters row k (nothing for k = 0).  In the occupancies'
    dtype, the window's rows added in row order and then the entering
    occupancy subtracted: on float32 occupancies this is, bit for bit, the
    score that the port's window search forms."""
    B, S1, T = gy.shape
    nk = S1 - s_range + 1
    blk = gy[:, :nk]
    for j in range(1, s_range):
        blk = blk + gy[:, j : j + nk]
    gx0 = torch.cat([gx.new_zeros((B, 1, gx.shape[2])), gx], dim=1)[:, :nk, :T]
    return (blk - gx0).transpose(1, 2)


def prune_ranges(gx, gy, boundary, s_range):
    """[B, T, s_range] windows from the occupancies (gx [B, S, T+1], gy
    [B, S+1, T]): the first best window start per frame; frames from each
    utterance's last one on take the last window; then starts are made
    monotone, 0-based and rising by less than s_range a frame."""
    B, S1, T = gy.shape
    s_range = min(s_range, S1)
    start = torch.argmax(window_scores(gx, gy, s_range), dim=2)  # [B, T]
    t = torch.arange(T, device=gy.device)[None, :]
    last = (boundary[:, 2:3].long() - s_range + 1).clamp(min=0)
    start = torch.where(t < boundary[:, 3:4].long() - 1, start, last)
    ramp = (s_range - 1) * t
    start = _suffix_min(start)
    start = -(_suffix_min(-(start - ramp))).clamp(min=0) + ramp
    # x -> -(x - ramp) is the "magic transform": a suffix minimum of the
    # transformed starts bounds each frame's rise by s_range - 1
    return start[:, :, None] + torch.arange(s_range, device=gy.device)
