"""Parity of the port's decoders (fast_rnnt_tpu_torch.models.decoding) with
the JAX package's, on the CPU: the float32 tiny model of tests/test_models.py
(vocab 32, 8 features, d 16, 1 layer, 2 heads, conv 7) carried across by
``params_from_flax``, the same numpy features to both.  Tokens and lengths
must be equal: greedy ``argmax`` takes the first maximum in both
frameworks, and the beam's top-H comes from a stable sort, which resolves
equal scores to the lower index as ``lax.top_k`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.models import TransducerConfig as JConfig
from fast_rnnt_tpu.models import greedy_search as jgreedy_search
from fast_rnnt_tpu.models import init_model as jinit_model
from fast_rnnt_tpu.models import modified_beam_search as jbeam_search
from fast_rnnt_tpu_torch.models import (
    PrunedTransducer,
    TransducerConfig,
    greedy_over_frames,
    greedy_search,
    modified_beam_search,
)
from fast_rnnt_tpu_torch.models import decoding as tdecoding
from fast_rnnt_tpu_torch.models.decoding import beam_best, beam_init_state
from fast_rnnt_tpu_torch.utils import params_from_flax

TINY = dict(vocab_size=32, feature_dim=8, d_model=16, d_joiner=16, num_layers=1, num_heads=2,
            conv_kernel=7)
MAX_LEN = 40  # 8 encoder frames x 4 symbols per frame + room


@pytest.fixture(scope="module")
def models():
    """The JAX model, its jitted greedy and beam searches (params as an
    argument: one compile per search and shape), and the port's copy."""
    jm, jp = jinit_model(jax.random.PRNGKey(0), JConfig(dtype=jnp.float32, **TINY))
    jp = jax.device_get(jp)
    searches = {
        ("greedy", ml): jax.jit(lambda p, f, l, ml=ml: jgreedy_search(jm, p, f, l, max_len=ml))
        for ml in (MAX_LEN, 5)
    }
    searches.update({
        ("beam", ml): jax.jit(lambda p, f, l, ml=ml: jbeam_search(jm, p, f, l, beam=4, max_len=ml))
        for ml in (MAX_LEN, 3)
    })
    model = PrunedTransducer(TransducerConfig(dtype=torch.float32, **TINY))
    model.load_state_dict(params_from_flax(jp), strict=True)
    return jp, searches, model


def _features(seed, B=4, T_in=32):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T_in, TINY["feature_dim"])).astype(np.float32)
    lens = np.array([T_in, 24, 17, 9][:B], np.int32)
    return feats, lens


CASES = [("greedy", MAX_LEN), ("greedy", 5), ("beam", MAX_LEN), ("beam", 3)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind,max_len", CASES, ids=[f"{k}-len{m}" for k, m in CASES])
def test_search_matches_jax(models, kind, max_len, seed):
    """Tokens and lengths equal; a short ``max_len`` drives the full-buffer
    rules (greedy stops emitting, the beam only extends with blank)."""
    jp, searches, model = models
    feats, lens = _features(seed)
    jh, jl = searches[(kind, max_len)](jp, jnp.asarray(feats), jnp.asarray(lens))
    f, fl = torch.tensor(feats), torch.tensor(lens)
    if kind == "greedy":
        h, hl = greedy_search(model, f, fl, max_len=max_len)
    else:
        h, hl = modified_beam_search(model, f, fl, beam=4, max_len=max_len)
    assert h.dtype == torch.int32 and tuple(h.shape) == (4, max_len)
    np.testing.assert_array_equal(hl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert int(hl.max()) > 0


def test_greedy_stop_check_is_idle_work(models, monkeypatch):
    """Reading the stop test every trip or every 8 trips gives the same
    result: a trip after every stream has finished changes nothing."""
    _, _, model = models
    feats, lens = _features(2)
    f, fl = torch.tensor(feats), torch.tensor(lens)
    want = greedy_search(model, f, fl, max_len=MAX_LEN)
    monkeypatch.setattr(tdecoding, "_STOP_CHECK_EVERY", 1)
    got = greedy_search(model, f, fl, max_len=MAX_LEN)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_greedy_over_frames_resumes(models):
    """Two blocks of frames with carried (ctx, hyps, lens) decode as one."""
    _, _, model = models
    feats, lens = _features(3)
    f, fl = torch.tensor(feats), torch.tensor(lens)
    want = greedy_search(model, f, fl, max_len=MAX_LEN)
    with torch.no_grad():
        am, out_lens = tdecoding._encode(model, f, fl)
    active = torch.arange(am.shape[1])[None, :] < out_lens[:, None]
    B = am.shape[0]
    state = (torch.zeros(B, 2, dtype=torch.int32), torch.zeros(B, MAX_LEN, dtype=torch.int32),
             torch.zeros(B, dtype=torch.int32))
    for lo, hi in ((0, 3), (3, am.shape[1])):
        state = greedy_over_frames(model, am[:, lo:hi], active[:, lo:hi], *state)
    assert torch.equal(state[1], want[0]) and torch.equal(state[2], want[1])


def test_beam_state_and_best():
    cfg = TransducerConfig(**TINY)
    scores, ctx, hyps, lens = beam_init_state(cfg, 2, 3, 5, device="cpu")
    assert scores[:, 0].eq(0).all() and torch.isneginf(scores[:, 1:]).all()
    assert ctx.shape == (2, 3, 2) and hyps.shape == (2, 3, 5) and not lens.any()
    s = torch.tensor([[0.0, 2.0, 2.0], [5.0, -1.0, float("-inf")]])
    h = torch.arange(30, dtype=torch.int32).reshape(2, 3, 5)
    ln = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    bh, bl = beam_best(s, h, ln)
    assert torch.equal(bh, torch.stack([h[0, 1], h[1, 0]])) and bl.tolist() == [2, 4]
