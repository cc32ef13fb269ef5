"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made once in numpy from a seed and handed to both the JAX
package and the port; results come back as numpy arrays and are compared
with the tolerances stated here:

  * fp32 losses and scores: |a - b| <= 1e-4 + 1e-5 |b|;
  * lattices (px, py, p) and occupancies: |a - b| <= 1e-5 + 1e-5 |b|
    (atol 1e-5 at these small sizes, where |values| are O(10));
  * build gradients (d_lm, d_am, d_uni) against the JAX package's XLA VJP
    or torch autograd: the lattice tolerance; against the Pallas build
    backward, |a - b| <= 1e-4 + 1e-4 |b|: that kernel forms its products
    as 2-term bf16 splits, ~2^-16 relative
    (fast_rnnt_tpu/ops/kernels/latbuild.py:333);
  * pruning ranges: equal, or every differing window start a near-tie
    (ROADMAP Queue 3): window scores within 1e-3.
  * occupancies stored in bfloat16 / float16 (the recursion computes in
    float32 on both sides): atol 1e-5 and the lattice rtol plus one step
    of the storage dtype (2^-7 relative for bf16, 2^-10 for f16), since
    two float32 values within the lattice tolerance may round to
    neighbouring steps (``storage_rtol``);
  * bf16 losses against float32 losses: rtol 5e-2, atol 0.1, the JAX
    package's own bf16 bound (tests/test_recursion.py:359-361).

Tier-1 runs six test workers on eight cores, so torch is held to one
thread.
"""

import numpy as np
import torch

torch.set_num_threads(1)

LOSS_ATOL, LOSS_RTOL = 1e-4, 1e-5
LAT_ATOL, LAT_RTOL = 1e-5, 1e-5
SPLIT_ATOL, SPLIT_RTOL = 1e-4, 1e-4
TIE_GAP = 1e-3
BF16_LOSS_ATOL, BF16_LOSS_RTOL = 0.1, 5e-2


def storage_rtol(dtype):
    """Relative tolerance of occupancies stored in ``dtype``."""
    step = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}.get(dtype, 0.0)
    return LAT_RTOL + step


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def tt(*arrays):
    """numpy -> CPU tensors (float32 / int32)."""
    from fast_rnnt_tpu_torch.utils import from_numpy

    return from_numpy(*arrays, device="cpu")


def jj(*arrays):
    import jax.numpy as jnp

    out = tuple(None if a is None else jnp.asarray(a) for a in arrays)
    return out[0] if len(out) == 1 else out


def assert_close(got, want, atol, rtol, what=""):
    """-inf patterns equal; finite entries within atol + rtol * |want|."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=f"{what}: -inf pattern")
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=rtol, err_msg=what)


def assert_loss_close(got, want, what=""):
    assert_close(got, want, LOSS_ATOL, LOSS_RTOL, what)


def assert_lattice_close(got, want, what=""):
    assert_close(got, want, LAT_ATOL, LAT_RTOL, what)


def loss_inputs(seed, B=3, T=17, S=6, C=12, ragged=True):
    """(am [B,T,C], lm [B,S+1,C], symbols [B,S], boundary [B,4]) in numpy."""
    rng = np.random.default_rng(seed)
    am = rng.normal(size=(B, T, C)).astype(np.float32)
    lm = rng.normal(size=(B, S + 1, C)).astype(np.float32)
    symbols = rng.integers(1, C, size=(B, S)).astype(np.int32)
    if ragged:
        se = rng.integers(max(S // 2, 1), S + 1, size=B)
        te = np.maximum(rng.integers(T // 2, T + 1, size=B), se + 2)
        te = np.minimum(te, T)
        te[0], se[0] = T, S  # one full-length utterance
    else:
        se, te = np.full(B, S), np.full(B, T)
    boundary = np.stack([np.zeros(B), np.zeros(B), se, te], axis=1).astype(np.int32)
    return am, lm, symbols, boundary


def rows_inputs(seed, B=3, S=5, T=11, modified=False, offset=False, neg_inf_frac=0.0):
    """Random s-major (px_rows, py_rows, boundary) with ragged ends and,
    when ``offset``, non-zero begins."""
    rng = np.random.default_rng(seed)
    T1 = T if modified else T + 1
    px = (rng.normal(size=(S, B, T1)) * 2.0).astype(np.float32)
    py = (rng.normal(size=(S + 1, B, T)) * 2.0).astype(np.float32)
    if not modified:
        px[:, :, -1] = -np.inf
    if neg_inf_frac:
        px[rng.random(px.shape) < neg_inf_frac] = -np.inf
        py[rng.random(py.shape) < neg_inf_frac] = -np.inf
    se = rng.integers(max(S // 2, 0), S + 1, size=B)
    te = rng.integers(max(T // 2, 1), T + 1, size=B)
    sb = rng.integers(0, se // 2 + 1) if offset else np.zeros(B, np.int64)
    tb = rng.integers(0, te // 3 + 1) if offset else np.zeros(B, np.int64)
    boundary = np.stack([sb, tb, se, te], axis=1).astype(np.int32)
    return px, py, boundary


def band(seed, B, S, T, K):
    """Monotone random band starts lo (B, T) in [0, S + 1 - K]."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, S + 2 - K, size=(B, T))
    return np.sort(lo, axis=1).astype(np.int32)


def pruned_inputs(seed, B=3, T=13, S=6, K=3, C=11, edges=False):
    """(logits [B, T, K, C] float32, symbols [B, S], ranges [B, T, K],
    boundary [B, 4]) in numpy for the pruned lattice: ranges lo + arange(K)
    from monotone starts lo in [0, S+1-K] (windows that reach row S, whose
    symbol is the termination symbol), utterance 0 full length.  ``edges``
    (B >= 4): utterance 1 empty (t_end = t_begin = 0), utterance 2 with
    s_end = 0, starts below 0 and past S+1-K in utterance 3 (ranges outside
    [0, S]), symbols -1 and C (out of the vocabulary)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, K, C)).astype(np.float32)
    symbols = rng.integers(1, C, size=(B, S)).astype(np.int32)
    se = rng.integers(0, S + 1, size=B)
    te = rng.integers(1, T + 1, size=B)
    se[0], te[0] = S, T
    lo = np.sort(rng.integers(0, S + 2 - K, size=(B, T)), axis=1)
    if edges:
        te[1] = se[1] = 0
        se[2] = 0
        lo[3, : T // 3] -= K
        lo[3, T // 3 : T // 2] -= 1
        lo[3, -(T // 3):] += rng.integers(1, K + 1)
        if S:
            symbols[0, 0], symbols[2, -1] = -1, C
    boundary = np.stack([np.zeros(B), np.zeros(B), se, te], axis=1).astype(np.int32)
    ranges = (lo[:, :, None] + np.arange(K)[None, None, :]).astype(np.int32)
    return logits, symbols, ranges, boundary


def assert_ranges_match(got, want, scores, what=""):
    """Window starts equal, or each differing start a near-tie of the
    window scores ``scores`` (K', B, T)."""
    got, want, scores = to_np(got), to_np(want), to_np(scores)
    diff = np.argwhere(got != want)
    for b, t in diff:
        gap = abs(scores[got[b, t], b, t] - scores[want[b, t], b, t])
        assert gap <= TIE_GAP, f"{what}: window start flip at b={b} t={t}, score gap {gap}"


def occupancies(seed, B, S, T, modified, quarter=False):
    """Non-negative (gy (S+1, B, T), gx (S, B, T or T+1)) float32 for the
    pruning-window search; with ``quarter``, multiples of 1/4 below 4,
    whose window sums are exact in float32 in any order and tie often."""
    rng = np.random.default_rng(seed)
    T1 = T if modified else T + 1
    if quarter:
        gy = rng.integers(0, 16, size=(S + 1, B, T)) / 4.0
        gx = rng.integers(0, 16, size=(S, B, T1)) / 4.0
    else:
        gy, gx = rng.random((S + 1, B, T)), rng.random((S, B, T1))
    return gy.astype(np.float32), gx.astype(np.float32)


def ranges_boundary(seed, B, S, T, te=None):
    """(B, 4) int32 boundary with random s_end in [0, S] and t_end in
    [0, T] (or ``te`` for every utterance)."""
    rng = np.random.default_rng(seed + 1000)
    se = rng.integers(0, S + 1, size=B)
    te = rng.integers(0, T + 1, size=B) if te is None else np.full(B, te)
    z = np.zeros(B, np.int64)
    return np.stack([z, z, se, te], axis=1).astype(np.int32)


# edge shapes of the pruning-window kernels, (B, S, T, K, modified, t_end):
# K = 1, 2, S+1; S + 2 - K < 8 (some of a tile's 8 slices of window starts
# empty); T not a multiple of the 32-frame tile, T = 1; t_end <= 1 (every
# frame padded), random t_end (also 0 and T otherwise)
RANGES_EDGES = [
    (3, 6, 40, 1, False, None),
    (3, 6, 40, 2, True, None),
    (2, 5, 37, 6, False, None),
    (2, 3, 45, 2, False, None),
    (3, 4, 33, 3, True, None),
    (2, 20, 64, 5, False, None),
    (2, 30, 70, 4, True, None),
    (3, 7, 1, 2, False, None),
    (3, 7, 1, 1, True, None),
    (2, 9, 50, 3, False, 1),
    (2, 9, 50, 3, True, 0),
    (4, 40, 65, 8, False, None),
]


def ranges_edge_id(case):
    B, S, T, K, modified, te = case
    return f"B{B}-S{S}-T{T}-K{K}-{'mod' if modified else 'reg'}-te{te}"


# the JAX streaming and serving tests' tiny causal model, float32
# (tests/test_streaming.py:26-33)
STREAM_TINY = dict(vocab_size=12, feature_dim=6, d_model=16, d_joiner=16, num_layers=2,
                   num_heads=2, conv_kernel=7, causal=True, attention_left_context=4)


def causal_models(seed, **kw):
    """The JAX package's tiny causal model from ``PRNGKey(seed)`` (STREAM_TINY
    updated by ``kw``) and the port's copy, its params carried across by
    ``params_from_flax`` and loaded strictly: (jax model, params, port model)."""
    import jax
    import jax.numpy as jnp

    from fast_rnnt_tpu.models import TransducerConfig as JConfig
    from fast_rnnt_tpu.models import init_model as jinit_model
    from fast_rnnt_tpu_torch.models import PrunedTransducer, TransducerConfig
    from fast_rnnt_tpu_torch.utils import params_from_flax

    cfg = {**STREAM_TINY, **kw}
    jm, jp = jinit_model(jax.random.PRNGKey(seed), JConfig(dtype=jnp.float32, **cfg))
    jp = jax.device_get(jp)
    model = PrunedTransducer(TransducerConfig(dtype=torch.float32, **cfg))
    model.load_state_dict(params_from_flax(jp), strict=True)
    return jm, jp, model


def pad_utts(utts):
    """Ragged (T_i, F) utterances -> zero-padded (B, T, F) float32 features
    and (B,) int32 lengths."""
    T = max(len(u) for u in utts)
    feats = np.zeros((len(utts), T, utts[0].shape[1]), np.float32)
    for i, u in enumerate(utts):
        feats[i, : len(u)] = u
    return feats, np.array([len(u) for u in utts], np.int32)
