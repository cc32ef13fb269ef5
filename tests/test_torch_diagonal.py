"""A numpy model of the fused recursion kernel's schedule
(fast_rnnt_tpu_torch/csrc/wavefront_fused.cu), held against the JAX
package's XLA recursion on the CPU.

The kernel cannot run here, so its index logic is pinned by this model.
One warp per utterance sweeps the anti-diagonals d = s + t of the
utterance's rectangle in strips of 32*R rows (row i of a strip is slot
i // 32 of lane i % 32; its neighbour row i-1 in the forward, i+1 in the
backward, comes from the next slot or lane, here the next array entry).
Each row keeps its last two cells (the modified recursion reads two
diagonals back).  Rows stream through rings of four 16-column tiles that
helper warps fill a block of 16 steps ahead and drain a block behind; the
forward's strip k reads row s0-1 back from p, the backward's strips run top
down and hand the g of their first row to the strip below through two
alternating rows after p in the scratch, and the band starts lo[b, t] are
read per cell (lo[b, t-1] kept from the step before).  The model shares
the kernel's schedule, tile arithmetic and masks; its arithmetic is
numpy's float32 logaddexp / exp.

Tolerances: scores 1e-4 + 1e-5|x| (the loss tolerance), p 1e-5 + 1e-5|x|
(the lattice tolerance), occupancies 1e-5 + 1e-4|x|: the model sums in
another order than the JAX row scan, which moves p by a few float32 steps
(~1e-5 at |p| ~ 100), and an occupancy is the exp of a difference of p
values (the split kernels' occupancy tolerance on the card, chip_smoke.py).
A fault of the index logic moves a result by O(1).
"""

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


def _forward_strip(pxb, pyb, p, b, q, k, s0, imax, mod, lob, K, R, scores):
    """One strip of the forward as the kernel runs it.  The helper warps'
    work of block m (the loads for block m+1, the stores of finished tiles)
    runs beside the sweep's block m in the kernel; here the loads go before
    it, and the stores both before and after it, which must read the same
    values.  So a load into a slot still in use, a store of a tile not yet
    finished, or a read of a tile never loaded poisons the result or fails
    (the rings start as NaN)."""
    sb, tb, se, te = q
    span, t_hi, strip = te - tb, te - mod, 32 * R
    rpx, rpy, rp = (np.full((strip, RING), np.nan, np.float32) for _ in range(3))
    hand = np.full(RING, np.nan, np.float32)

    def load(m):
        for i in range(imax + 1):
            v = (m + _tile0(i) + 1) * TILE + COLS
            s, t = s0 + i, tb + v
            tp = t - mod
            rpx[i, v & 63] = np.where((s > sb) & (tp >= tb) & (tp <= t_hi), _take(pxb, s - 1, tp), NEG)
            rpy[i, v & 63] = np.where((t - 1 >= tb) & (t - 1 < te), _take(pyb, s, t - 1), NEG)
        v = (m + 1) * TILE + COLS
        tp = tb + v - mod
        ok = (k > 0) & (tp >= tb) & (tp <= t_hi)
        hand[v & 63] = np.where(ok, _take(p[:, b], np.full_like(tp, s0 - 1), tp), NEG)

    def store(m):
        """Stores tile m + tile0(i) - 1 of every row; returns what it read."""
        out = []
        for i in range(imax + 1):
            v = (m + _tile0(i) - 1) * TILE + COLS
            v = v[(v >= 0) & (v <= span)]
            p[s0 + i, b, tb + v] = rp[i, v & 63]
            out.append(rp[i, v & 63].copy())
        return out

    rows = np.arange(strip)
    s = s0 + rows
    v1 = np.full(strip, NEG)
    v2 = np.full(strip, NEG)
    lprev = np.zeros(strip, np.int64)
    n = imax + span + 1
    nb = -(-n // TILE)
    load(-1)
    load(0)
    for m in range(nb):
        # the helpers run beside block m: their loads land before it and
        # their stores read tiles that block m must not change
        if m + 1 < nb:
            load(m + 1)
        before = store(m)
        for x in range(m * TILE, min(n, (m + 1) * TILE)):
            v = x - rows
            t = tb + v
            at = v & 63
            xa, ya = rpx[rows, at], rpy[rows, at]
            act = (rows <= imax) & (v >= 0) & (v <= span)
            if lob is not None:
                lt = np.where(act, lob[np.clip(t, 0, len(lob) - 1)], 0)
                xa = np.where(_band_ok(lprev if mod else lt, s - 1, K), xa, NEG)
                ya = np.where(_band_ok(lprev, s, K), ya, NEG)
                lprev = lt
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


def _backward_strip(pxb, pyb, p, b, q, k, nk, s0, imax, mod, lob, K, R, S, pxg, pyg):
    """One strip of the backward (strips top down), as the forward's."""
    sb, tb, se, te = q
    span, t_hi, strip = te - tb, te - mod, 32 * R
    T, T1 = pyg.shape[2], pxg.shape[2]
    rpp, rpx, rpy, rgx, rgy = (np.full((strip, RING), np.nan, np.float32) for _ in range(5))
    hand_p = np.full(RING, np.nan, np.float32)
    hand_g = np.full(RING, np.nan, np.float32)
    g_in, g_out = S + 1 + ((k + 1) & 1), S + 1 + (k & 1)

    def load(m):
        for qk in range(imax + 1):
            i = imax - qk
            w = (m + _tile0(qk) + 1) * TILE + COLS
            s, t = s0 + i, te - w
            inside = (t >= tb) & (t <= te)
            rpp[i, w & 63] = np.where(inside, _take(p[:, b], np.full_like(t, s), t), NEG)
            rpx[i, w & 63] = np.where(inside & (s < se) & (t <= t_hi), _take(pxb, s, t), NEG)
            rpy[i, w & 63] = np.where(inside & (t < te), _take(pyb, s, t), NEG)
        w = (m + 1) * TILE + COLS
        tn = te - w + mod
        ok = (k < nk - 1) & (tn >= tb) & (tn <= te)
        hand_p[w & 63] = np.where(ok, _take(p[:, b], np.full_like(tn, s0 + imax + 1), tn), NEG)
        hand_g[w & 63] = np.where(ok, _take(p[:, b], np.full_like(tn, g_in), tn), np.float32(0))

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

    rows = np.arange(strip)
    s = s0 + rows
    pc1 = np.full(strip, NEG)
    g1 = np.zeros(strip, np.float32)
    g2 = np.zeros(strip, np.float32)
    n = imax + span + 1
    nb = -(-n // TILE)
    load(-1)
    load(0)
    for m in range(nb):
        if m + 1 < nb:
            load(m + 1)
        before = store(m)
        for x in range(m * TILE, min(n, (m + 1) * TILE)):
            w = x - imax + rows
            t = te - w
            at = w & 63
            act = (rows <= imax) & (w >= 0) & (w <= span)
            pc, xa, ya = rpp[rows, at], rpx[rows, at], rpy[rows, at]
            if lob is not None:
                ok = act & _band_ok(np.where(act, lob[np.clip(t, 0, len(lob) - 1)], 0), s, K)
                xa = np.where(ok, xa, NEG)
                ya = np.where(ok, ya, NEG)
            # row i+1 at t+dt: p from row i+1's ring (its cell dt steps
            # back), g from its state; the top slot's from the strip above
            # (hand rings)
            ap = np.concatenate([rpp[rows[1:], (w[:-1] - mod) & 63], [hand_p[x & 63]]])
            ag = np.concatenate([(g2 if mod else g1)[1:], [hand_g[x & 63]]])
            h = _safe_exp(pc + xa - ap) * ag
            c = _safe_exp(pc + ya - pc1)
            seed = np.where((s == se) & (t == te), np.float32(1), np.float32(0))
            g = (c * g1 + (h + seed)).astype(np.float32)
            rgy[rows[act], at[act]] = (c * g1)[act]
            rgx[rows[act], at[act]] = h[act]
            if s0 > sb and act[0]:
                p[g_out, b, t[0]] = g[0]
            pc1 = np.where(act, pc, NEG)
            g2, g1 = g1, np.where(act, g, np.float32(0))
        for x, y in zip(store(m), before):
            np.testing.assert_array_equal(x, y, err_msg="a stored tile changed during its block")
    store(nb)
    store(nb + 1)


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


def diagonal_model(px, py, bnd, lo=None, K=0, R=1):
    """(scores [B], px_grad [S, B, T'], py_grad [S+1, B, T], p scratch
    [S+3, B, T+1]) by the kernel's schedule; every output starts as NaN, so
    a cell that no part of the schedule writes stays NaN."""
    S, B, T1 = px.shape
    T = py.shape[2]
    mod = int(T1 == T)
    strip = 32 * R
    p = np.full((S + 3, B, T + 1), np.nan, np.float32)
    scores = np.full(B, np.nan, np.float32)
    pxg = np.full((S, B, T1), np.nan, np.float32)
    pyg = np.full((S + 1, B, T), np.nan, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(B):
            q = tuple(int(v) for v in bnd[b])
            sb, se = q[0], q[2]
            lob = lo[b] if lo is not None else None
            nk = -(-(se - sb + 1) // strip)
            _zero_outside(pxg, pyg, b, q)
            for k in range(nk):
                s0 = sb + k * strip
                _forward_strip(px[:, b], py[:, b], p, b, q, k, s0, min(strip - 1, se - s0), mod,
                               lob, K, R, scores)
            for k in range(nk - 1, -1, -1):
                s0 = sb + k * strip
                _backward_strip(px[:, b], py[:, b], p, b, q, k, nk, s0, min(strip - 1, se - s0),
                                mod, lob, K, R, S, pxg, pyg)
    return scores, pxg, pyg, p


def _jax_reference(px, py, bnd, lo=None, K=0):
    p, sc = jrec._forward_rows_xla(*jj(px, py, bnd), lo=jj(lo), K=K)
    gx, gy = jrec._backward_rows_xla(*jj(px, py), p, jj(bnd), jnp.ones(px.shape[1]), lo=jj(lo), K=K)
    return np.asarray(sc), np.asarray(gx), np.asarray(gy), np.asarray(p)


def _check(px, py, bnd, lo=None, K=0, R=1):
    sc, gx, gy, p = diagonal_model(px, py, bnd, lo, K, R)
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
    in the forward, g rows down in the backward, the alternating rows) run
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
