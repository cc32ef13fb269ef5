"""The pruning-window kernels (``fast_rnnt_tpu_torch/csrc/ranges.cu``) on
the CPU: their raw argmax in its own summation order
(``window_argmax_kernel_order``) against the JAX package's Pallas ranges
kernel in interpret mode, and a numpy model of the kernels' schedule (the
32-frame tiles, the 8 slices of window starts per tile, the cross-warp
reduction and its tie rule, the skipped padded frames, the repair block on
the raw-start scratch) against that function plus the padding and repair,
on edge shapes.  The kernels themselves run only on the card
(tests/test_torch_cuda.py); the model pins their index logic here."""

import numpy as np
import pytest
import torch

from fast_rnnt_tpu.ops.kernels.ranges import window_argmax_rows_pallas
from fast_rnnt_tpu_torch.ops.kernels import ranges
from fast_rnnt_tpu_torch.ops.pruning import _window_scores, adjust_pruning_lower_bound

from ._torch_parity import (
    RANGES_EDGES,
    assert_ranges_match,
    jj,
    occupancies,
    ranges_boundary,
    ranges_edge_id,
    tt,
)

KT, KW = 32, 8  # frames of an argmax block, window-start slices (its warps)
FLT_MAX = np.float32(np.finfo(np.float32).max)
INT_MAX = 2**31 - 1
UNWRITTEN = -(2**30)  # the raw scratch before the argmax grid writes it


def _repaired(raw, bnd, K, step):
    """The padding and repair of a raw argmax, as the port's plain version
    applies them (``pruning._window_starts_plain``)."""
    raw, bnd = torch.as_tensor(raw, dtype=torch.int32), torch.as_tensor(bnd)
    t = torch.arange(raw.shape[1])[None, :]
    pad = (bnd[:, 2:3] - K + 1).clamp(min=0).to(torch.int32)
    return adjust_pruning_lower_bound(torch.where(t < bnd[:, 3:4] - 1, raw, pad), step).numpy()


def _model_window_starts(gy, gx, K, bnd, step):
    """The two kernels' schedule in numpy, float32 as on the card.  The
    argmax grid: block = (tile, utterance) flattened as on gridDim.x, lane
    = frame, warp = a contiguous slice of window starts walked four at a
    time then one at a time, the slices' winners reduced in warp order
    (larger score, or equal score and smaller k); tiles holding no live
    frame return at once.  The repair: one block of nt threads per
    utterance, each owning a contiguous segment of u = T - 1 - t, two
    passes of segment minima, an inclusive scan of them and the segment
    sweeps.  Reading a raw start that the grid did not write fails."""
    S1, B, T = gy.shape
    gy, gx = gy.astype(np.float32), gx.astype(np.float32)
    nk = S1 - K + 1
    per = -(-nk // KW)
    n_tiles = -(-T // KT)
    raw = np.full((B, T), UNWRITTEN, np.int64)
    for blk in range(B * n_tiles):
        b, t0 = blk // n_tiles, (blk % n_tiles) * KT
        te = int(bnd[b, 3])
        if t0 >= te - 1:
            continue
        lanes = t0 + np.arange(KT)
        live = (lanes < T) & (lanes < te - 1)
        tl = np.minimum(lanes, T - 1)  # a dead lane reads nothing used
        best_s = np.empty((KW, KT), np.float32)
        arg_s = np.empty((KW, KT), np.int64)
        for warp in range(KW):
            k0 = min(warp * per, nk)
            k1 = min(k0 + per, nk)
            best = np.full(KT, -FLT_MAX, np.float32)
            arg = np.full(KT, INT_MAX, np.int64)

            def take(k, a):
                score = a - gx[k - 1, b, tl] if k > 0 else a
                hit = (score > best) if k != k0 else np.ones(KT, bool)
                best[hit], arg[hit] = score[hit], k

            k = k0
            while k + 4 <= k1:
                a = [gy[k + i, b, tl].copy() for i in range(4)]
                for j in range(1, K):
                    for i in range(4):
                        a[i] = a[i] + gy[k + i + j, b, tl]
                for i in range(4):
                    take(k + i, a[i])
                k += 4
            while k < k1:
                a = gy[k, b, tl].copy()
                for j in range(1, K):
                    a = a + gy[k + j, b, tl]
                take(k, a)
                k += 1
            if k0 == k1:
                best[:] = -np.inf
            best_s[warp], arg_s[warp] = best, arg
        best, arg = best_s[0].copy(), arg_s[0].copy()
        for w in range(1, KW):
            s, k = best_s[w], arg_s[w]
            hit = (s > best) | ((s == best) & (k < arg))
            best[hit], arg[hit] = s[hit], k[hit]
        raw[b, lanes[live]] = arg[live]

    out = np.empty((B, T), np.int64)
    nt = min(1024, max(32, -(-T // 32) * 32))
    E = -(-T // nt)
    for b in range(B):
        se, te = int(bnd[b, 2]), int(bnd[b, 3])
        sbeg = np.empty(T, np.int64)
        for t in range(T):
            if t < te - 1:
                assert raw[b, t] != UNWRITTEN, f"raw start ({b}, {t}) read before it was written"
                sbeg[t] = raw[b, t]
            else:
                sbeg[t] = max(se - K + 1, 0)
        for pass_ in range(2):
            seg = [range(min(i * E, T), min(min(i * E, T) + E, T)) for i in range(nt)]
            loc = np.array([min((sbeg[T - 1 - u] for u in r), default=INT_MAX) for r in seg])
            xend = np.minimum.accumulate(loc)
            for i, r in enumerate(seg):
                x = xend[i - 1] if i > 0 else INT_MAX
                for u in r:
                    t = T - 1 - u
                    x = min(x, sbeg[t])
                    ramp = (step - 1) * t
                    sbeg[t] = ramp - x if pass_ == 0 else ramp - max(x, 0)
        out[b] = sbeg
    return out


def _kernel_order(gy, gx, K, dtype=torch.float32):
    return ranges.window_argmax_kernel_order(torch.from_numpy(gy).to(dtype),
                                             torch.from_numpy(gx).to(dtype), K).numpy()


@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
@pytest.mark.parametrize("S,T,K", [(6, 40, 1), (6, 40, 3), (9, 33, 2), (5, 20, 6), (13, 70, 5)])
def test_kernel_order_equals_pallas_raw_argmax_on_exact_sums(S, T, K, modified):
    """On quarter-valued occupancies every window sum is exact, so the
    kernels' direct sums and the Pallas kernel's rolling sum agree to the
    bit, and the frequent real ties must go to the first maximum in both."""
    gy, gx = occupancies(S * 100 + T + K, 3, S, T, modified, quarter=True)
    want = np.asarray(window_argmax_rows_pallas(*jj(gy, gx), K, interpret=True))
    np.testing.assert_array_equal(_kernel_order(gy, gx, K), want)


@pytest.mark.parametrize("modified", [False, True], ids=["regular", "modified"])
@pytest.mark.parametrize("S,T,K", [(6, 40, 3), (20, 50, 5), (40, 30, 41)])
def test_kernel_order_follows_pallas_up_to_near_ties(S, T, K, modified):
    """On random occupancies the two summation orders may flip an argmax
    only at a near-tie (window scores within 1e-3)."""
    gy, gx = occupancies(7 * S + K, 4, S, T, modified)
    want = np.asarray(window_argmax_rows_pallas(*jj(gy, gx), K, interpret=True))
    assert_ranges_match(_kernel_order(gy, gx, K), want, _window_scores(*tt(gx, gy), K))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("quarter", [False, True], ids=["random", "quarter"])
@pytest.mark.parametrize("case", RANGES_EDGES, ids=[ranges_edge_id(c) for c in RANGES_EDGES])
def test_schedule_model_equals_kernel_order_and_repair(case, quarter, dtype):
    """The numpy model of the two kernels equals the padding and repair of
    ``window_argmax_kernel_order`` exactly, the occupancies read in their
    storage dtype and summed in float32."""
    B, S, T, K, modified, te = case
    gy, gx = occupancies(B * 1000 + S * 10 + T, B, S, T, modified, quarter)
    gy = torch.from_numpy(gy).to(dtype).float().numpy()  # the stored values
    gx = torch.from_numpy(gx).to(dtype).float().numpy()
    bnd = ranges_boundary(T + S, B, S, T, te)
    step = 2 if modified else K
    want = _repaired(_kernel_order(gy, gx, K, dtype), bnd, K, step)
    np.testing.assert_array_equal(_model_window_starts(gy, gx, K, bnd, step), want)


def test_schedule_model_ties_across_slices_go_to_the_first_start():
    """Equal scores in two warps' slices: the smaller window start wins the
    cross-warp reduction, as the first maximum of the whole search."""
    S, T, K = 30, 34, 3
    gy = np.ones((S + 1, 1, T), np.float32)
    gx = np.zeros((S, 1, T), np.float32)
    bnd = np.array([[0, 0, S, T]], np.int32)
    raw = _kernel_order(gy, gx, K)
    assert (raw[0, :] == 0).all()  # every window scores 3: the first wins
    gy[20:23, 0, :5] = 2.0  # ... unless a later slice holds a strictly larger one
    np.testing.assert_array_equal(_kernel_order(gy, gx, K)[0, :5], 20)
    want = _repaired(_kernel_order(gy, gx, K), bnd, K, K)
    np.testing.assert_array_equal(_model_window_starts(gy, gx, K, bnd, K), want)
