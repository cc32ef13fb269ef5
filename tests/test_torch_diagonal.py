"""A numpy model of the diagonal-sweep recursion kernels' schedule
(fast_rnnt_tpu_torch/csrc/wavefront_fused.cu): the fused launch, and the
forward and backward phases launched apart, held against the JAX package's
XLA recursion on the CPU.

The kernel cannot run here, so its index logic is pinned by this model.
One warp per utterance sweeps the anti-diagonals d = s + t of the
utterance's rectangle in strips of 32*R rows (row i of a strip is slot
i // 32 of lane i % 32; its neighbour row i-1 in the forward, i+1 in the
backward, comes from the next slot or lane, here the next array entry).
Each row keeps its last two cells (the modified recursion reads two
diagonals back).  Rows stream through rings of four 16-column tiles that
helper warps fill a block of 16 steps ahead and drain a block behind; the
forward's strip k reads row s0-1 back from p, the backward's strips run top
down and hand the g of their first row to the strip below through hand-off
row k (after p in the fused launch's scratch, a separate (strips, B, T+1)
scratch for the backward alone), and the helpers mask the band lo[b, t] <=
s < lo[b, t] + K into the px and py tiles as they load them.  Strips run
one after another, or all at once: then each strip publishes its progress
on the row it hands on (the forward the top row's tiles stored, the
backward the steps of its first row's g written) in a counter, the strip
that reads that row waits on it, and a scheduler interleaves the strips'
tile blocks in a seeded random order, each one resumed right after it
publishes, so a count one tile or step ahead of what was written reads the
NaN the scratch starts with; the results must equal the strip-serial
schedule's bit for bit.  The forward alone fills p with -inf outside each rectangle, and the
backward alone reads p (read-only here) and seeds with ans_grad.  The model
shares the kernel's schedule, tile arithmetic and masks; its arithmetic is
numpy's float32 logaddexp / exp.

Tolerances: scores 1e-4 + 1e-5|x| (the loss tolerance), p 1e-5 + 1e-5|x|
(the lattice tolerance), occupancies 1e-5 + 1e-4|x|: the model sums in
another order than the JAX row scan, which moves p by a few float32 steps
(~1e-5 at |p| ~ 100), and an occupancy is the exp of a difference of p
values (the split kernels' occupancy tolerance on the card, chip_smoke.py).
A fault of the index logic moves a result by O(1).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

import fast_rnnt_tpu as jft
from fast_rnnt_tpu.ops import recursion as jrec
from fast_rnnt_tpu.ops.lattice import get_rnnt_logprobs_rows

from ._torch_parity import (
    assert_close,
    assert_lattice_close,
    assert_loss_close,
    jj,
    loss_inputs,
    rows_inputs,
)

NEG = np.float32(-np.inf)
OCC_ATOL, OCC_RTOL = 1e-5, 1e-4


def _band_ok(lo, s, K):
    return (lo <= s) & (s < lo + K)


def _safe_exp(x):
    with np.errstate(invalid="ignore", over="ignore"):
        return np.where(np.isnan(x) | (x > 88.6), np.float32(0), np.exp(x)).astype(np.float32)


def _take(a, i, j):
    """a[i, j] with out-of-range indices clipped (callers mask those)."""
    if a.size == 0:  # S = 0: no px rows
        return np.full(np.broadcast(i, j).shape, NEG)
    return a[np.clip(i, 0, a.shape[0] - 1), np.clip(j, 0, a.shape[1] - 1)]


TILE, RING = 16, 64
COLS = np.arange(TILE)


def _tile0(q):
    """First tile of the row of rank q in the sweep order."""
    return (-q) // TILE


def _band(lob, t, s, K):
    """The band test of lo[b, t] (edge-padded to T+1 columns) at row s; True
    without a band."""
    if lob is None:
        return np.ones(np.broadcast(t, s).shape, bool)
    return _band_ok(lob[np.clip(t, 0, len(lob) - 1)], s, K)


def _forward_strip(pxb, pyb, p, b, q, k, nk, s0, imax, mod, lob, K, R, scores, prog=None):
    """One strip of the forward as the kernel runs it, a generator that
    yields "wait" where the strip waits on the strip below and "block" after
    each publication.  The helper warps' work of block m (the loads for
    block m+1, the stores of finished tiles) runs beside the sweep's block m
    in the kernel; here the loads go before it, and the stores both before
    and after it, which must read the same values.  So a load into a slot
    still in use, a store of a tile not yet finished, or a read of a tile
    never loaded poisons the result or fails (the rings start as NaN).
    ``prog``: the utterance's forward counters (strips at once), or None."""
    sb, tb, se, te = q
    span, t_hi, strip = te - tb, te - mod, 32 * R
    rpx, rpy, rp = (np.full((strip, RING), np.nan, np.float32) for _ in range(3))
    hand = np.full(RING, np.nan, np.float32)

    def load(m):
        for i in range(imax + 1):
            v = (m + _tile0(i) + 1) * TILE + COLS
            s, t = s0 + i, tb + v
            tp = t - mod
            okx = (s > sb) & (tp >= tb) & (tp <= t_hi) & _band(lob, tp, s - 1, K)
            oky = (t - 1 >= tb) & (t - 1 < te) & _band(lob, t - 1, s, K)
            rpx[i, v & 63] = np.where(okx, _take(pxb, s - 1, tp), NEG)
            rpy[i, v & 63] = np.where(oky, _take(pyb, s, t - 1), NEG)
        v = (m + 1) * TILE + COLS
        tp = tb + v - mod
        ok = (k > 0) & (tp >= tb) & (tp <= t_hi)
        vals = np.full(TILE, NEG)
        for c in np.flatnonzero(ok):  # one helper lane a column
            # strip k-1 has stored the tile of its top row that holds tp
            while prog is not None and prog[k - 1] < (tp[c] - tb) // TILE + 1:
                yield "wait"
            vals[c] = p[s0 - 1, b, tp[c]]
        hand[v & 63] = vals

    def store(m):
        """Stores tile m + tile0(i) - 1 of every row; returns what it read."""
        out = []
        for i in range(imax + 1):
            v = (m + _tile0(i) - 1) * TILE + COLS
            v = v[(v >= 0) & (v <= span)]
            p[s0 + i, b, tb + v] = rp[i, v & 63]
            out.append(rp[i, v & 63].copy())
        return out

    def publish(m):
        """After store(m) and a block barrier: the top row's tiles 0 .. m +
        tile0(imax) - 1 are stored."""
        if prog is not None and k < nk - 1 and m + _tile0(imax) > 0:
            prog[k] = m + _tile0(imax)

    rows = np.arange(strip)
    s = s0 + rows
    v1 = np.full(strip, NEG)
    v2 = np.full(strip, NEG)
    n = imax + span + 1
    nb = -(-n // TILE)
    yield from load(-1)
    yield from load(0)
    for m in range(nb):
        publish(m - 1)  # the helpers' stores of block m-1
        yield "block"
        # the helpers run beside block m: their loads land before it and
        # their stores read tiles that block m must not change
        if m + 1 < nb:
            yield from load(m + 1)
        before = store(m)
        for x in range(m * TILE, min(n, (m + 1) * TILE)):
            v = x - rows
            t = tb + v
            at = v & 63
            xa, ya = rpx[rows, at], rpy[rows, at]
            act = (rows <= imax) & (v >= 0) & (v <= span)
            below = np.concatenate([[hand[x & 63]], (v2 if mod else v1)[:-1]])
            a = np.where((s == sb) & (t == tb), np.float32(0), below + xa)
            val = np.logaddexp(a, v1 + ya).astype(np.float32)
            rp[rows[act], at[act]] = val[act]
            hit = act & (s == se) & (t == te)
            if hit.any():
                scores[b] = val[hit][0]
            v2, v1 = v1, np.where(act, val, NEG)
        for x, y in zip(store(m), before):
            np.testing.assert_array_equal(x, y, err_msg="a stored tile changed during its block")
    store(nb)
    store(nb + 1)
    publish(nb + 1)
    yield "block"


def _backward_strip(pxb, pyb, p, hrows, b, q, k, nk, s0, imax, mod, lob, K, R, S, seed_g, pxg, pyg,
                    prog=None):
    """One strip of the backward (strips top down), as the forward's; g is
    handed down through row k of ``hrows`` and seeded with ``seed_g``;
    ``prog``: the utterance's backward counters, or None."""
    sb, tb, se, te = q
    span, t_hi, strip = te - tb, te - mod, 32 * R
    T, T1 = pyg.shape[2], pxg.shape[2]
    rpp, rpx, rpy, rgx, rgy = (np.full((strip, RING), np.nan, np.float32) for _ in range(5))
    hand_p = np.full(RING, np.nan, np.float32)
    hand_g = np.full(RING, np.nan, np.float32)
    g_in, g_out = k + 1, k

    def load(m):
        for qk in range(imax + 1):
            i = imax - qk
            w = (m + _tile0(qk) + 1) * TILE + COLS
            s, t = s0 + i, te - w
            inside = (t >= tb) & (t <= te)
            band = inside & _band(lob, t, s, K)
            rpp[i, w & 63] = np.where(inside, _take(p[:, b], np.full_like(t, s), t), NEG)
            rpx[i, w & 63] = np.where(band & (s < se) & (t <= t_hi), _take(pxb, s, t), NEG)
            rpy[i, w & 63] = np.where(band & (t < te), _take(pyb, s, t), NEG)
        w = (m + 1) * TILE + COLS
        tn = te - w + mod
        ok = (k < nk - 1) & (tn >= tb) & (tn <= te)
        hp, hg = np.full(TILE, NEG), np.zeros(TILE, np.float32)
        for c in np.flatnonzero(ok):  # one helper lane a column
            # the strip above has written its first row's g at w - dt
            while prog is not None and prog[k + 1] < w[c] - mod + 1:
                yield "wait"
            hp[c], hg[c] = p[s0 + imax + 1, b, tn[c]], hrows[g_in, b, tn[c]]
        hand_p[w & 63], hand_g[w & 63] = hp, hg

    def store(m):
        """Stores tile m + tile0(imax - i) - 1 of every row; returns what it read."""
        out = []
        for qk in range(imax + 1):
            i = imax - qk
            w = (m + _tile0(qk) - 1) * TILE + COLS
            w = w[(w >= 0) & (w <= span)]
            s, t = s0 + i, te - w
            pyg[s, b, t[t < T]] = rgy[i, w[t < T] & 63]
            if s < S:
                pxg[s, b, t[t < T1]] = rgx[i, w[t < T1] & 63]
            out += [rgy[i, w & 63].copy(), rgx[i, w & 63].copy()]
        return out

    def publish(done):
        """The first row's g of the first ``done`` steps of w is written."""
        if prog is not None and k > 0 and done > 0:
            prog[k] = done

    rows = np.arange(strip)
    s = s0 + rows
    pc1 = np.full(strip, NEG)
    g1 = np.zeros(strip, np.float32)
    g2 = np.zeros(strip, np.float32)
    n = imax + span + 1
    nb = -(-n // TILE)
    yield from load(-1)
    yield from load(0)
    for m in range(nb):
        publish(m * TILE - imax)  # steps 0 .. 16m-1 are done
        yield "block"
        if m + 1 < nb:
            yield from load(m + 1)
        before = store(m)
        for x in range(m * TILE, min(n, (m + 1) * TILE)):
            w = x - imax + rows
            t = te - w
            at = w & 63
            act = (rows <= imax) & (w >= 0) & (w <= span)
            pc, xa, ya = rpp[rows, at], rpx[rows, at], rpy[rows, at]
            # row i+1 at t+dt: p from row i+1's ring (its cell dt steps
            # back), g from its state; the top slot's from the strip above
            # (hand rings)
            ap = np.concatenate([rpp[rows[1:], (w[:-1] - mod) & 63], [hand_p[x & 63]]])
            ag = np.concatenate([(g2 if mod else g1)[1:], [hand_g[x & 63]]])
            h = _safe_exp(pc + xa - ap) * ag
            c = _safe_exp(pc + ya - pc1)
            seed = np.where((s == se) & (t == te), np.float32(seed_g), np.float32(0))
            g = (c * g1 + (h + seed)).astype(np.float32)
            rgy[rows[act], at[act]] = (c * g1)[act]
            rgx[rows[act], at[act]] = h[act]
            if s0 > sb and act[0]:
                hrows[g_out, b, t[0]] = g[0]
            pc1 = np.where(act, pc, NEG)
            g2, g1 = g1, np.where(act, g, np.float32(0))
        for x, y in zip(store(m), before):
            np.testing.assert_array_equal(x, y, err_msg="a stored tile changed during its block")
    publish(span + 1)
    store(nb)
    store(nb + 1)
    yield "block"


def _zero_outside(pxg, pyg, b, q):
    """The helper warps' zeros of px_grad / py_grad outside the rectangle."""
    sb, tb, se, te = q
    S = pxg.shape[0]
    for unit in range(2 * (S + 1)):
        s, out = unit >> 1, unit & 1
        if out and s == S:
            continue
        o = pxg if out else pyg
        n = o.shape[2]
        inside = sb <= s <= se
        a, c = (min(tb, n), te + 1) if inside else (n, n)
        o[s, b, :a] = 0
        o[s, b, c:] = 0


def _neg_outside(p, b, q):
    """The helper warps' -inf of p outside the rectangle (the forward alone)."""
    sb, tb, se, te = q
    W = p.shape[2]
    for s in range(p.shape[0]):
        a, c = (tb, te + 1) if sb <= s <= se else (W, W)
        p[s, b, :a] = NEG
        p[s, b, c:] = NEG


def _strips(bnd, b, R):
    """(q, [(k, first row, imax) of each strip, bottom up])."""
    q = tuple(int(v) for v in bnd[b])
    sb, se, strip = q[0], q[2], 32 * R
    nk = -(-(se - sb + 1) // strip)
    return q, [(k, sb + k * strip, min(strip - 1, se - sb - k * strip)) for k in range(nk)]


def _grid_strips(S, R):
    """Strips of the padded lattice: the hand-off rows and counters a
    launch has for each utterance."""
    return -(-(S + 1) // (32 * R))


def _forward_phase(px, py, p, bnd, lo, K, R, scores, b, prog=None):
    """The utterance's forward strips, bottom up, as generators."""
    q, strips = _strips(bnd, b, R)
    return [_forward_strip(px[:, b], py[:, b], p, b, q, k, len(strips), s0, imax,
                           int(px.shape[2] == py.shape[2]), None if lo is None else lo[b], K, R,
                           scores, prog)
            for k, s0, imax in strips]


def _backward_phase(px, py, p, hrows, bnd, lo, K, R, ag, pxg, pyg, b, prog=None):
    """The utterance's backward strips, bottom up, as generators."""
    q, strips = _strips(bnd, b, R)
    return [_backward_strip(px[:, b], py[:, b], p, hrows, b, q, k, len(strips), s0, imax,
                            int(px.shape[2] == py.shape[2]), None if lo is None else lo[b], K, R,
                            px.shape[0], ag, pxg, pyg, prog)
            for k, s0, imax in strips]


def _one_after_another(strips):
    """Strip after strip: no strip may wait."""
    for gen in strips:
        assert "wait" not in gen, "a strip waited in the strip-serial schedule"


def _at_once(strips, seed):
    """Every strip at once: each round resumes every strip once, in a seeded
    random order, each to its next wait or publication; a round in which
    every strip waits is a deadlock."""
    rng = np.random.default_rng(seed)
    live = list(strips)
    while live:
        moved = False
        for i in rng.permutation(len(live)):
            try:
                moved |= next(live[i]) != "wait"
            except StopIteration:
                live[i], moved = None, True
        live = [g for g in live if g is not None]
        assert moved or not live, "every strip waits on another: deadlock"


def _counters(bnd, R, S):
    """Zeroed progress counters of each utterance (one a grid strip)."""
    return np.zeros((len(bnd), _grid_strips(S, R)), np.int64)


def _outputs(px, py):
    """NaN-filled scores, px_grad and py_grad: a cell that no part of the
    schedule writes stays NaN."""
    S, B, T1 = px.shape
    T = py.shape[2]
    return (np.full(B, np.nan, np.float32), np.full((S, B, T1), np.nan, np.float32),
            np.full((S + 1, B, T), np.nan, np.float32))


def diagonal_model(px, py, bnd, lo=None, K=0, R=1, at_once=None):
    """The fused launch: (scores [B], px_grad [S, B, T'], py_grad [S+1, B,
    T], p scratch [S+1+strips, B, T+1]) by the kernel's schedule, seed 1,
    the hand-off rows after p in the scratch.  ``at_once``: None, strip
    after strip; or the seed of the order in which all strips run at once,
    each block its strip's forward, then its backward."""
    S, B, _ = px.shape
    T = py.shape[2]
    p = np.full((S + 1 + _grid_strips(S, R), B, T + 1), np.nan, np.float32)
    scores, pxg, pyg = _outputs(px, py)
    fprog, bprog = _counters(bnd, R, S), _counters(bnd, R, S)
    blocks = []
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(B):
            _zero_outside(pxg, pyg, b, tuple(int(v) for v in bnd[b]))
            if at_once is None:
                _one_after_another(_forward_phase(px, py, p, bnd, lo, K, R, scores, b))
                _one_after_another(reversed(
                    _backward_phase(px, py, p, p[S + 1 :], bnd, lo, K, R, 1.0, pxg, pyg, b)))
            else:
                fwd = _forward_phase(px, py, p, bnd, lo, K, R, scores, b, fprog[b])
                bwd = _backward_phase(px, py, p, p[S + 1 :], bnd, lo, K, R, 1.0, pxg, pyg, b,
                                      bprog[b])
                blocks += [itertools.chain(f, g) for f, g in zip(fwd, bwd)]
        if at_once is not None:
            _at_once(blocks, at_once)
    return scores, pxg, pyg, p


def sweep_fwd_model(px, py, bnd, lo=None, K=0, R=1, at_once=None):
    """The forward launched alone: (p_rows [S+1, B, T+1], -inf outside each
    rectangle, scores [B]); ``at_once`` as :func:`diagonal_model`'s."""
    S, B, _ = px.shape
    p = np.full((S + 1, B, py.shape[2] + 1), np.nan, np.float32)
    scores = _outputs(px, py)[0]
    fprog = _counters(bnd, R, S)
    strips = []
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(B):
            fwd = _forward_phase(px, py, p, bnd, lo, K, R, scores, b,
                                 None if at_once is None else fprog[b])
            if at_once is None:
                _one_after_another(fwd)
            strips += fwd
        if at_once is not None:
            _at_once(strips, at_once)
        for b in range(B):
            _neg_outside(p, b, tuple(int(v) for v in bnd[b]))
    return p, scores


def sweep_bwd_model(px, py, p_rows, bnd, ans_grad, lo=None, K=0, R=1, at_once=None):
    """The backward launched alone: (px_grad, py_grad) seeded with
    ``ans_grad`` [B], reading ``p_rows`` (made read-only here: the kernel
    must not write it) and handing g rows down through a separate NaN-filled
    (strips, B, T+1) scratch; ``at_once`` as :func:`diagonal_model`'s."""
    S, B, _ = px.shape
    p = p_rows.copy()
    p.setflags(write=False)
    hrows = np.full((_grid_strips(S, R), B, py.shape[2] + 1), np.nan, np.float32)
    _, pxg, pyg = _outputs(px, py)
    bprog = _counters(bnd, R, S)
    strips = []
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(B):
            _zero_outside(pxg, pyg, b, tuple(int(v) for v in bnd[b]))
            bwd = _backward_phase(px, py, p, hrows, bnd, lo, K, R, np.float32(ans_grad[b]), pxg,
                                  pyg, b, None if at_once is None else bprog[b])
            if at_once is None:
                _one_after_another(reversed(bwd))
            strips += bwd
        if at_once is not None:
            _at_once(strips, at_once)
    return pxg, pyg


def _jax_reference(px, py, bnd, lo=None, K=0):
    p, sc = jrec._forward_rows_xla(*jj(px, py, bnd), lo=jj(lo), K=K)
    gx, gy = jrec._backward_rows_xla(*jj(px, py), p, jj(bnd), jnp.ones(px.shape[1]), lo=jj(lo), K=K)
    return np.asarray(sc), np.asarray(gx), np.asarray(gy), np.asarray(p)


def _same_bits(got, want, names, what):
    for a, w, name in zip(got, want, names):
        np.testing.assert_array_equal(a, w, err_msg=f"{what}: {name}")


def _check(px, py, bnd, lo=None, K=0, R=1):
    """The fused model against the JAX package; and its strips all at once,
    in two orders, bit for bit against strip after strip."""
    sc, gx, gy, p = diagonal_model(px, py, bnd, lo, K, R)
    for order in (1, 2):
        got = diagonal_model(px, py, bnd, lo, K, R, at_once=order)
        _same_bits(got[:3], (sc, gx, gy), ("scores", "px_grad", "py_grad"), "strips at once")
        for b, (sb, tb, se, te) in enumerate(bnd):
            np.testing.assert_array_equal(got[3][sb : se + 1, b, tb : te + 1],
                                          p[sb : se + 1, b, tb : te + 1], "strips at once: p")
    sc_j, gx_j, gy_j, p_j = _jax_reference(px, py, bnd, lo, K)
    assert_loss_close(sc, sc_j, "scores")
    assert_close(gx, gx_j, OCC_ATOL, OCC_RTOL, "px_grad")
    assert_close(gy, gy_j, OCC_ATOL, OCC_RTOL, "py_grad")
    # p inside each rectangle (the only cells the sweep writes or reads)
    for b, (sb, tb, se, te) in enumerate(bnd):
        assert_lattice_close(p[sb : se + 1, b, tb : te + 1], p_j[sb : se + 1, b, tb : te + 1], "p")


@pytest.mark.parametrize("offset", [False, True], ids=["zero-begins", "offset"])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_model_matches_jax_across_strips(modified, offset):
    """S = 70 with R = 1: three 32-row strips, so both hand-offs (p rows up
    in the forward, g rows down in the backward, a hand-off row a strip) run
    between full strips and into a partial top strip; T = 100: four tiles
    per row, so the rings wrap; ragged ends."""
    px, py, bnd = rows_inputs(40, B=3, S=70, T=100, modified=modified, offset=offset)
    bnd[0, 2] = 70  # one utterance spans all three strips
    _check(px, py, bnd, R=1)


@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_model_matches_jax_in_one_wide_strip(modified):
    """R = 4 (the kernel's own strip of 128 rows) at S = 9 and R = 2 at an
    S that fills a strip exactly (S + 1 = 64)."""
    _check(*rows_inputs(41, B=3, S=9, T=90, modified=modified, offset=True), R=4)
    px, py, bnd = rows_inputs(42, B=2, S=63, T=70, modified=modified)
    bnd[:, 2] = 63
    _check(px, py, bnd, R=2)


@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_model_matches_jax_at_s0(modified):
    """S = 0: one row, no px arcs."""
    _check(*rows_inputs(43, B=3, S=0, T=70, modified=modified), R=1)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_model_matches_jax_banded_by_jax_ranges(rnnt_type):
    """The band of the pruned stage: lo = ranges[:, :, 0] from the JAX
    package's own simple loss and pruning, on its simple lattice, with
    S = 40 over two strips (R = 1)."""
    am, lm, sym, bnd = loss_inputs(44, B=3, T=80, S=40, C=9)
    bnd[:, 2] = np.maximum(bnd[:, 2], 33)  # past the first strip
    _, (gx, gy) = jft.rnnt_loss_simple(*jj(lm, am, sym), 0, jj(bnd), rnnt_type=rnnt_type,
                                       reduction="sum", calc_gradients=True)
    K = 4
    ranges = np.asarray(jft.get_rnnt_prune_ranges(gx, gy, jj(bnd), K))
    px, py = get_rnnt_logprobs_rows(*jj(lm, am, sym), 0, rnnt_type, jj(bnd))
    px, py = np.asarray(px, np.float32), np.asarray(py, np.float32)
    _check(px, py, bnd, np.ascontiguousarray(ranges[:, :, 0]), K, R=1)


def test_model_matches_jax_banded_random_offsets():
    """A random monotone band over non-zero begins, modified, two strips."""
    px, py, bnd = rows_inputs(45, B=3, S=40, T=75, modified=True, offset=True)
    rng = np.random.default_rng(46)
    lo = np.sort(rng.integers(0, 40, size=(3, 75)), axis=1).astype(np.int32)
    _check(px, py, bnd, lo, 6, R=1)


# --- the phases launched apart -------------------------------------------

# seeds of the backward alone: 0, a negative value and one that is not 1
# (cycled over the batch)
SEEDS = np.array([0.0, -1.7, 2.5], np.float32)


def _check_split(px, py, bnd, lo=None, K=0, R=1):
    """The forward alone against ``_forward_rows_xla`` in every cell of p
    (-inf outside each rectangle included), the backward alone with the
    seeds above against ``_backward_rows_xla``, and the pair seeded with
    ones against the fused launch bit for bit."""
    B = px.shape[1]
    ag = np.resize(SEEDS, B)
    p, sc = sweep_fwd_model(px, py, bnd, lo, K, R)
    p_j, sc_j = jrec._forward_rows_xla(*jj(px, py, bnd), lo=jj(lo), K=K)
    assert not np.isnan(p).any(), "a cell of p that the forward never writes"
    assert_loss_close(sc, np.asarray(sc_j), "scores")
    assert_lattice_close(p, np.asarray(p_j), "p (every cell)")
    gx, gy = sweep_bwd_model(px, py, p, bnd, ag, lo, K, R)
    gx_j, gy_j = jrec._backward_rows_xla(*jj(px, py), p_j, jj(bnd), jnp.asarray(ag), lo=jj(lo), K=K)
    assert_close(gx, np.asarray(gx_j), OCC_ATOL, OCC_RTOL, "px_grad")
    assert_close(gy, np.asarray(gy_j), OCC_ATOL, OCC_RTOL, "py_grad")
    fused = diagonal_model(px, py, bnd, lo, K, R)
    pair = (sc, *sweep_bwd_model(px, py, p, bnd, np.ones(B, np.float32), lo, K, R))
    _same_bits(pair, fused, ("scores", "px_grad", "py_grad"), "pair vs fused")
    # each phase with its strips all at once, bit for bit against strip after strip
    _same_bits(sweep_fwd_model(px, py, bnd, lo, K, R, at_once=3), (p, sc), ("p", "scores"),
               "forward, strips at once")
    _same_bits(sweep_bwd_model(px, py, p, bnd, ag, lo, K, R, at_once=4), (gx, gy),
               ("px_grad", "py_grad"), "backward, strips at once")


@pytest.mark.parametrize("offset", [False, True], ids=["zero-begins", "offset"])
@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_split_model_matches_jax_across_strips(modified, offset):
    """S = 70 with R = 1: three strips, so the hand-offs run through the
    separate (strips, B, T+1) scratch between full strips and into a partial top
    strip; ragged ends, and with ``offset`` non-zero begins, so p has -inf
    rows and columns on every side of a rectangle."""
    px, py, bnd = rows_inputs(47, B=3, S=70, T=100, modified=modified, offset=offset)
    bnd[0, 2] = 70
    _check_split(px, py, bnd, R=1)


@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
def test_split_model_matches_jax_in_one_wide_strip_and_at_s0(modified):
    """R = 4 (the kernel's own strip) with non-zero begins, and S = 0."""
    _check_split(*rows_inputs(48, B=3, S=9, T=90, modified=modified, offset=True), R=4)
    _check_split(*rows_inputs(49, B=3, S=0, T=40, modified=modified), R=1)


@pytest.mark.parametrize("rnnt_type", ["regular", "modified"])
def test_split_model_matches_jax_banded_by_jax_ranges(rnnt_type):
    """Stage 2 as the pipelines run it: lo = ranges[:, :, 0] from the JAX
    package's simple loss and pruning, over two strips (R = 1)."""
    am, lm, sym, bnd = loss_inputs(50, B=3, T=80, S=40, C=9)
    bnd[:, 2] = np.maximum(bnd[:, 2], 33)
    _, (gx, gy) = jft.rnnt_loss_simple(*jj(lm, am, sym), 0, jj(bnd), rnnt_type=rnnt_type,
                                       reduction="sum", calc_gradients=True)
    K = 4
    ranges = np.asarray(jft.get_rnnt_prune_ranges(gx, gy, jj(bnd), K))
    px, py = get_rnnt_logprobs_rows(*jj(lm, am, sym), 0, rnnt_type, jj(bnd))
    px, py = np.asarray(px, np.float32), np.asarray(py, np.float32)
    _check_split(px, py, bnd, np.ascontiguousarray(ranges[:, :, 0]), K, R=1)


def test_split_model_matches_jax_banded_random_offsets():
    """A random monotone band over non-zero begins, modified, two strips."""
    px, py, bnd = rows_inputs(51, B=3, S=40, T=75, modified=True, offset=True)
    lo = np.sort(np.random.default_rng(52).integers(0, 40, size=(3, 75)), axis=1).astype(np.int32)
    _check_split(px, py, bnd, lo, 6, R=1)
