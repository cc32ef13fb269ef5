"""Chunked streaming in the port (fast_rnnt_tpu_torch.models.streaming)
against offline decoding and against the JAX package, on the CPU.

Counterparts of tests/test_streaming.py at its tiny float32 widths (vocab
12, 6 features, d_model 16, 2 layers, 2 heads, conv 7, attention left
context 4), the JAX model's weights carried across by ``params_from_flax``
and the same numpy features to both.  Tolerances:

  * tokens and lengths: equal, streamed against the port's offline
    ``greedy_search`` / ``modified_beam_search`` and against the JAX
    package's;
  * ``encode_stream`` rows per chunk, the port's against the JAX
    package's, and the carried state leaves after the layout transpose
    (the port's subsampling tails are NCHW, the JAX package's NHWC):
    |a - b| <= 1e-5 + 1e-5 |b|; the streamed rows against the port's
    offline rows of the same frames, the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.models import greedy_search as jgreedy_search
from fast_rnnt_tpu.models import modified_beam_search as jbeam_search
from fast_rnnt_tpu.models import StreamingConfig as JStreamingConfig
from fast_rnnt_tpu.models import streaming_init as jstreaming_init
from fast_rnnt_tpu.models import streaming_step as jstreaming_step
from fast_rnnt_tpu_torch.models import (
    PrunedTransducer,
    StreamingConfig,
    TransducerConfig,
    encoder_stream_state,
    greedy_search,
    modified_beam_search,
    streaming_init,
    streaming_step,
)

from ._torch_parity import STREAM_TINY, causal_models

ROW_ATOL = ROW_RTOL = 1e-5


def _features(seed, B, T, lens):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, STREAM_TINY["feature_dim"])).astype(np.float32)
    return feats, np.asarray(lens, np.int32)


def _chunks(feats, flens, chunk):
    """The zero-padded features cut into chunks, with each chunk's lengths."""
    T = feats.shape[1]
    n = -(-T // chunk)
    fp = np.pad(feats, ((0, 0), (0, n * chunk - T), (0, 0)))
    for i in range(n):
        yield fp[:, i * chunk : (i + 1) * chunk], np.clip(flens - i * chunk, 0, chunk).astype(np.int32)


def _stream(model, scfg, feats, flens):
    """The port's streamed (hyps, lens), numpy."""
    state = streaming_init(model, scfg, feats.shape[0])
    for fc, cl in _chunks(feats, flens, scfg.chunk):
        state, (hyps, lens) = streaming_step(model, scfg, state, torch.tensor(fc), torch.tensor(cl))
    return hyps.numpy(), lens.numpy()


def _offline(jm, jp, model, feats, flens, max_len, beam=0):
    """Offline tokens of the port and of the JAX package, numpy."""
    f, fl = torch.tensor(feats), torch.tensor(flens)
    if beam:
        got = modified_beam_search(model, f, fl, beam=beam, max_len=max_len)
        want = jax.jit(lambda p, a, b: jbeam_search(jm, p, a, b, beam=beam, max_len=max_len))(
            jp, jnp.asarray(feats), jnp.asarray(flens))
    else:
        got = greedy_search(model, f, fl, max_len=max_len)
        want = jax.jit(lambda p, a, b: jgreedy_search(jm, p, a, b, max_len=max_len))(
            jp, jnp.asarray(feats), jnp.asarray(flens))
    return tuple(x.numpy() for x in got), tuple(np.asarray(x) for x in want)


def _assert_tokens(streamed, port_offline, jax_offline):
    for want in (port_offline, jax_offline):
        np.testing.assert_array_equal(streamed[1], want[1])
        np.testing.assert_array_equal(streamed[0], want[0])
    assert int(streamed[1].max()) > 0, "degenerate test: nothing was emitted"


def test_streaming_matches_offline_exactly():
    """Ragged lengths, one stream ending mid-chunk (tests/test_streaming.py:36)."""
    jm, jp, model = causal_models(0)
    feats, flens = _features(0, 3, 152, [152, 132, 113])
    streamed = _stream(model, StreamingConfig(chunk=16, left=128, max_len=64), feats, flens)
    _assert_tokens(streamed, *_offline(jm, jp, model, feats, flens, 64))


def _jax_state(st):
    """The JAX package's encoder state in the port's layout, numpy."""
    nchw = (0, 3, 1, 2)
    return {"in_tail": np.transpose(np.asarray(st["in_tail"]), nchw),
            "mid_tail": np.transpose(np.asarray(st["mid_tail"]), nchw),
            "att": [np.asarray(a) for a in st["att"]],
            "conv": [np.asarray(c) for c in st["conv"]],
            "seen": np.asarray(st["seen"])}


@pytest.mark.parametrize("chunk", [4, 16])
def test_encode_stream_rows_and_state_match_jax(chunk):
    """Per chunk, the port's ``encode_stream`` rows against the JAX
    package's, and every carried state leaf after the layout transpose;
    the streamed rows against the port's offline rows of the same frames."""
    jm, jp, model = causal_models(0)
    feats, flens = _features(1, 3, 64, [64, 50, 37])
    jenc = jax.jit(lambda p, fc, st: jm.apply(p, fc, st, method=lambda m, a, b: m.encode_stream(a, b)))
    jst = jstreaming_init(jm, JStreamingConfig(chunk=chunk), 3)["enc"]
    st = encoder_stream_state(model.cfg, 3, "cpu")
    rows = []
    with torch.no_grad():
        for fc, _ in _chunks(feats, flens, chunk):
            am, st = model.encode_stream(torch.tensor(fc), st)
            jam, jst = jenc(jp, jnp.asarray(fc), jst)
            np.testing.assert_allclose(am.numpy(), np.asarray(jam), rtol=ROW_RTOL, atol=ROW_ATOL)
            want = _jax_state(jst)
            for key in ("in_tail", "mid_tail", "seen"):
                assert st[key].shape == want[key].shape, key
                np.testing.assert_allclose(st[key].numpy(), want[key], rtol=ROW_RTOL, atol=ROW_ATOL,
                                           err_msg=key)
            for key in ("att", "conv"):
                assert len(st[key]) == len(want[key]) == STREAM_TINY["num_layers"]
                for a, b in zip(st[key], want[key]):
                    np.testing.assert_allclose(a.numpy(), b, rtol=ROW_RTOL, atol=ROW_ATOL, err_msg=key)
            rows.append(am)
        enc, out_lens = model.encoder(torch.tensor(feats), torch.tensor(flens))
        offline = model.am_proj(enc)
    streamed = torch.cat(rows, dim=1)
    for b, n in enumerate(out_lens.tolist()):
        np.testing.assert_allclose(streamed[b, :n].numpy(), offline[b, :n].numpy(),
                                   rtol=ROW_RTOL, atol=ROW_ATOL)


def test_streaming_one_step_function_many_chunks():
    """Seven chunks through one ``streaming_step``: every state leaf keeps
    its shape, dtype and device from chunk to chunk (the JAX package's one
    compile, tests/test_streaming.py:69), and the tokens equal the JAX
    package's streamed tokens and the port's offline decode."""
    jm, jp, model = causal_models(1, num_layers=1)
    rng = np.random.default_rng(1)
    B, chunk, n = 2, 8, 7
    feats = rng.normal(size=(B, chunk * n, STREAM_TINY["feature_dim"])).astype(np.float32)
    scfg = StreamingConfig(chunk=chunk, left=48, max_len=32)
    jscfg = JStreamingConfig(chunk=chunk, left=48, max_len=32)
    jstep = jax.jit(lambda p, st, fc, cl: jstreaming_step(jm, p, jscfg, st, fc, cl))
    state, jstate = streaming_init(model, scfg, B), jstreaming_init(jm, jscfg, B)

    def leaves(st):
        out = []
        for v in st.values():
            out.extend(leaves(v) if isinstance(v, dict) else v if isinstance(v, list) else [v])
        return out

    layout = [(x.shape, x.dtype, x.device) for x in leaves(state)]
    full = np.full((B,), chunk, np.int32)
    for i in range(n):
        fc = feats[:, i * chunk : (i + 1) * chunk]
        state, (hyps, lens) = streaming_step(model, scfg, state, torch.tensor(fc), torch.tensor(full))
        jstate, (jhyps, jlens) = jstep(jp, jstate, jnp.asarray(fc), jnp.asarray(full))
        assert [(x.shape, x.dtype, x.device) for x in leaves(state)] == layout
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
        np.testing.assert_array_equal(hyps.numpy(), np.asarray(jhyps))
    off = greedy_search(model, torch.tensor(feats), torch.tensor(np.full((B,), chunk * n, np.int32)),
                        max_len=32)
    np.testing.assert_array_equal(hyps.numpy(), off[0].numpy())
    np.testing.assert_array_equal(lens.numpy(), off[1].numpy())


def test_streaming_requires_causal_encoder():
    cfg = TransducerConfig(vocab_size=8, feature_dim=4, d_model=8, d_joiner=8, num_layers=1,
                           num_heads=1, dtype=torch.float32, causal=False)
    model = PrunedTransducer(cfg)
    with pytest.raises(ValueError, match="causal"):
        streaming_init(model, StreamingConfig(chunk=8, left=32), 1)
    with pytest.raises(ValueError, match="causal"):
        model.encoder.step(torch.zeros(1, 8, 4), {})


def test_streaming_config_validation():
    with pytest.raises(ValueError, match="multiple of 4"):
        StreamingConfig(chunk=10)
    # `left` is accepted and ignored
    assert StreamingConfig(chunk=16, left=40).chunk == 16


@pytest.mark.parametrize("chunk", [8, 32, 4])
def test_streaming_parity_config_sweep(chunk):
    """Any chunk size (tests/test_streaming.py:110)."""
    jm, jp, model = causal_models(3, num_layers=1, attention_left_context=3)
    feats, flens = _features(chunk, 2, 96, [96, 85])
    streamed = _stream(model, StreamingConfig(chunk=chunk, max_len=48), feats, flens)
    _assert_tokens(streamed, *_offline(jm, jp, model, feats, flens, 48))


def test_streaming_exact_with_large_receptive_field_and_tiny_chunks():
    """Chunk 4 against a receptive field of many chunks: 2 layers,
    attention left context 16, conv 15 (tests/test_streaming.py:140)."""
    jm, jp, model = causal_models(4, attention_left_context=16, conv_kernel=15)
    feats, flens = _features(4, 2, 64, [64, 55])
    streamed = _stream(model, StreamingConfig(chunk=4, max_len=32), feats, flens)
    _assert_tokens(streamed, *_offline(jm, jp, model, feats, flens, 32))


def test_streaming_beam_matches_offline_beam():
    """``StreamingConfig(beam=4)`` carries the beam across chunks
    (tests/test_streaming.py:167)."""
    jm, jp, model = causal_models(7)
    feats, flens = _features(7, 2, 128, [128, 111])
    streamed = _stream(model, StreamingConfig(chunk=16, left=96, max_len=48, beam=4), feats, flens)
    _assert_tokens(streamed, *_offline(jm, jp, model, feats, flens, 48, beam=4))


def test_causal_without_left_context_is_still_causal():
    """causal=True with attention_left_context=None attends kk <= q only:
    changing input frames >= t0 leaves the earlier encoder rows as they
    were (tests/test_streaming.py:198); the rows equal the JAX package's."""
    jm, jp, model = causal_models(2, attention_left_context=None)
    rng = np.random.default_rng(3)
    B, T, t0 = 2, 32, 24
    feats = rng.normal(size=(B, T, STREAM_TINY["feature_dim"])).astype(np.float32)
    flens = np.full((B,), T, np.int32)
    feats_b = feats.copy()
    feats_b[:, t0:] = rng.normal(size=(B, T - t0, STREAM_TINY["feature_dim"]))

    def encode(f):
        with torch.no_grad():
            return model.encoder(torch.tensor(f), torch.tensor(flens))[0].numpy()

    enc_a, enc_b = encode(feats), encode(feats_b)
    want, _ = jm.apply(jp, jnp.asarray(feats), jnp.asarray(flens), method=lambda m, x, l: m.encoder(x, l))
    np.testing.assert_allclose(enc_a, np.asarray(want), rtol=ROW_RTOL, atol=ROW_ATOL)
    unaffected = [j for j in range(enc_a.shape[1]) if 4 * j < t0]
    assert unaffected and len(unaffected) < enc_a.shape[1]
    np.testing.assert_allclose(enc_a[:, unaffected], enc_b[:, unaffected], rtol=ROW_RTOL, atol=ROW_ATOL)
    assert not np.array_equal(enc_a, enc_b)


def test_streaming_init_rejects_unbounded_attention():
    model = PrunedTransducer(TransducerConfig(dtype=torch.float32, **{**STREAM_TINY,
                                                                      "attention_left_context": None}))
    with pytest.raises(ValueError, match="attention_left_context"):
        streaming_init(model, StreamingConfig(chunk=16), 1)
    with pytest.raises(ValueError, match="attention_left_context"):
        model.encoder.step(torch.zeros(1, 16, STREAM_TINY["feature_dim"]), {})
