"""The port's host library (``fast_rnnt_tpu_torch.csrc``) and data pipeline
(``fast_rnnt_tpu_torch.data``) against the JAX package's: the counterparts
of tests/test_csrc.py and tests/test_features.py.

The port builds its own copy of the same C++ sources with the same flags,
so fbank, streamed fbank, the batch planner and cummin must agree bit for
bit; the native recursion must equal the JAX binding's and the port's
plain recursion at the lattice tolerance (1e-5 + 1e-5 |x|)."""

import threading
import time

import numpy as np
import pytest
import torch

from fast_rnnt_tpu import csrc as jcsrc
from fast_rnnt_tpu import data as jdata
from fast_rnnt_tpu_torch import csrc, cummin, mutual_information_recursion
from fast_rnnt_tpu_torch.data import (
    BatchPlan,
    RaggedBatcher,
    StreamingFbank,
    collate_batch,
    fbank_cpu,
    prefetch,
)

from ._torch_parity import LAT_ATOL, LAT_RTOL, tt
from .oracle import mi_loop
from .test_features import _fbank_numpy
from .test_recursion import _random_boundary, _random_pxpy


def _wav(seed, n=16000):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * 0.1).astype(np.float32)


def _ragged(seed, n=20, F=8):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(int(t), F)).astype(np.float32) for t in rng.integers(40, 200, size=n)]
    syms = [rng.integers(1, 30, size=int(s)).astype(np.int32) for s in rng.integers(2, 12, size=n)]
    return feats, syms


def test_library_builds_under_build_host():
    lib = csrc.load_library()
    path = csrc.library_path()
    assert path.exists() and path.parent == csrc.BUILD_DIR
    assert csrc.BUILD_DIR.parts[-2:] == ("build", "host")
    assert lib is csrc.load_library()


@pytest.mark.parametrize("modified", [False, True])
def test_cpp_oracle_triangle(modified):
    """Native forward and occupancy backward: bit-equal to the JAX
    binding's, and at the lattice tolerance to the numpy oracle and to the
    port's plain recursion."""
    rng = np.random.default_rng(0)
    B, S, T = 3, 5, 9
    px, py = _random_pxpy(rng, B, S, T, modified=modified)
    boundary = _random_boundary(rng, B, S, T)
    ones = np.ones(B, np.float32)

    p, scores = csrc.mi_forward_cpu(px, py, boundary)
    pxg, pyg = csrc.mi_backward_cpu(px, py, p, boundary, ones)
    jp, jscores = jcsrc.mi_forward_cpu(px, py, boundary)
    jpxg, jpyg = jcsrc.mi_backward_cpu(px, py, jp, boundary, ones)
    for got, want in ((p, jp), (scores, jscores), (pxg, jpxg), (pyg, jpyg)):
        np.testing.assert_array_equal(got, want)

    scores_np, pxg_np, pyg_np, _ = mi_loop(px, py, boundary)
    np.testing.assert_allclose(scores, scores_np, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pxg, pxg_np, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pyg, pyg_np, rtol=2e-4, atol=2e-5)

    t_scores, (t_pxg, t_pyg) = mutual_information_recursion(*tt(px, py, boundary), calc_gradients=True)
    np.testing.assert_allclose(scores, t_scores.numpy(), rtol=LAT_RTOL, atol=LAT_ATOL)
    np.testing.assert_allclose(pxg, t_pxg.numpy(), rtol=LAT_RTOL, atol=LAT_ATOL)
    np.testing.assert_allclose(pyg, t_pyg.numpy(), rtol=LAT_RTOL, atol=LAT_ATOL)


def test_cpp_cummin():
    rng = np.random.default_rng(1)
    x = rng.integers(-50, 50, size=(4, 17)).astype(np.int32)
    got = csrc.cummin_cpu(x)
    np.testing.assert_array_equal(got, np.minimum.accumulate(x, axis=1))
    np.testing.assert_array_equal(got, jcsrc.cummin_cpu(x))
    np.testing.assert_array_equal(got, cummin(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("quantum", [16, 32, 64])
def test_plan_batches_properties(quantum):
    """tests/test_csrc.py's planner properties, and the JAX binding's plan."""
    rng = np.random.default_rng(2)
    n = 100
    frame_lens = rng.integers(50, 900, size=n).astype(np.int32)
    sym_lens = rng.integers(1, 80, size=n).astype(np.int32)
    max_frames, max_batch = 4000, 8
    plans = csrc.plan_batches_cpu(frame_lens, sym_lens, max_frames, max_batch, quantum)

    seen = np.concatenate([idx for idx, _, _ in plans])
    assert sorted(seen.tolist()) == list(range(n)), "every utterance exactly once"
    for idx, t_pad, s_pad in plans:
        assert len(idx) <= max_batch
        assert t_pad % quantum == 0 and s_pad % quantum == 0
        assert frame_lens[idx].max() <= t_pad
        assert sym_lens[idx].max() <= s_pad
        if len(idx) > 1:  # frame budget (single oversized utterances exempt)
            assert len(idx) * t_pad <= max_frames

    want = jcsrc.plan_batches_cpu(frame_lens, sym_lens, max_frames, max_batch, quantum)
    assert len(plans) == len(want)
    for (idx, t_pad, s_pad), (jidx, jt, js) in zip(plans, want):
        np.testing.assert_array_equal(idx, jidx)
        assert (t_pad, s_pad) == (jt, js)


@pytest.mark.parametrize("pad_batch_to", [None, 4])
def test_ragged_batcher_end_to_end(pad_batch_to):
    """Plans and padded batches equal to the JAX package's, with and
    without a static batch dim."""
    feats, syms = _ragged(3)
    kw = dict(max_frames=1024, max_batch=4, quantum=32, pad_batch_to=pad_batch_to)
    batcher, jbatcher = RaggedBatcher(**kw), jdata.RaggedBatcher(**kw)

    lens = ([len(f) for f in feats], [len(s) for s in syms])
    plans, jplans = batcher.plan(*lens), jbatcher.plan(*lens)
    assert len(plans) == len(jplans)
    for p, jp in zip(plans, jplans):
        assert isinstance(p, BatchPlan)
        np.testing.assert_array_equal(p.indices, jp.indices)
        assert (p.padded_frames, p.padded_symbols) == (jp.padded_frames, jp.padded_symbols)

    total, shapes = 0, set()
    got = list(batcher.batches(feats, syms))
    want = list(jbatcher.batches(feats, syms))
    assert len(got) == len(want) == len(plans)
    for batch, jbatch in zip(got, want):
        for a, b in zip(batch, jbatch):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        b_feats, b_flens, b_syms, b_slens = batch
        if pad_batch_to is not None:
            assert b_feats.shape[0] == pad_batch_to
        shapes.add(b_feats.shape)
        real = b_flens > 0
        total += int(real.sum())
        assert np.all(b_flens[real] <= b_feats.shape[1])
        assert np.all(b_slens[real] <= b_syms.shape[1])
    assert total == len(feats)
    assert len(shapes) <= 6


def test_collate_batch_matches_jax():
    feats, syms = _ragged(4, n=6)
    plan = BatchPlan(np.array([4, 1, 3], np.int32), 256, 16)
    jplan = jdata.BatchPlan(plan.indices, 256, 16)
    for a, b in zip(collate_batch(feats, syms, plan), jdata.collate_batch(feats, syms, jplan)):
        np.testing.assert_array_equal(a, b)


def test_prefetch_iterator():
    """Background prefetch preserves order and propagates exceptions."""
    assert list(prefetch(iter(range(10)), depth=3)) == list(range(10))

    def boom():
        yield 1
        raise ValueError("producer failed")

    it = prefetch(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)


def test_prefetch_abandoned_consumer_releases_producer():
    """Breaking out of a prefetch loop early must not leak the producer
    thread blocked on a full queue."""
    produced = []

    def src():
        for i in range(100_000):
            produced.append(i)
            yield i

    before = set(threading.enumerate())
    it = prefetch(src(), depth=2)
    assert next(it) == 0
    it.close()  # GeneratorExit -> stop event + queue drain

    deadline = time.time() + 5.0
    extra = True
    while time.time() < deadline:
        extra = [t for t in threading.enumerate() if t not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, f"producer thread leaked: {extra}"
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n  # producer stopped consuming the source


def test_fbank_rejects_invalid_n_fft():
    wav = np.zeros(1600, np.float32)
    with pytest.raises(ValueError, match="power of two"):
        fbank_cpu(wav, n_fft=400)
    with pytest.raises(ValueError, match="win_len"):
        fbank_cpu(wav, win_len=400, n_fft=256)
    with pytest.raises(ValueError, match="power of two"):
        StreamingFbank(n_fft=400)
    with pytest.raises(ValueError, match="win_len"):
        StreamingFbank(win_len=400, n_fft=256)


@pytest.mark.parametrize(
    "kw",
    [{}, {"n_mels": 40, "hop": 80}, {"sample_rate": 8000, "win_len": 200, "n_fft": 256, "high_hz": 3800.0}],
    ids=["default", "40mel-hop80", "8k"],
)
def test_fbank_bit_equal_to_jax(kw):
    wav = _wav(5)
    got = fbank_cpu(wav, **kw)
    want = jcsrc.fbank_cpu(wav, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_fbank_matches_numpy_reference():
    wav = _wav(0)
    got = fbank_cpu(wav)
    want = _fbank_numpy(wav)
    assert got.shape == want.shape == (98, 80)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_fbank_edge_cases():
    assert fbank_cpu(np.zeros(100, np.float32)).shape[0] == 0  # shorter than a window
    sr, f0 = 16000, 1000.0
    t = np.arange(sr, dtype=np.float32) / sr
    tone = np.sin(2 * np.pi * f0 * t).astype(np.float32)
    feats = fbank_cpu(tone)
    assert int(feats[10].argmax()) == int(_fbank_numpy(tone)[10].argmax())


def _split(n, chunk, rng=None):
    if chunk == "random":
        sizes, total = [], 0
        while total < n:
            sizes.append(int(rng.integers(1, 3000)))
            total += sizes[-1]
        return sizes
    return [chunk] * (-(-n // chunk))


@pytest.mark.parametrize("chunk", [1, 37, 160, 4000, "random"])
def test_streaming_fbank_bit_equal(chunk):
    """Chunked extraction == one offline call, bit for bit, and each
    chunk's frames == the JAX package's StreamingFbank's."""
    wav = _wav(0, 8000 if chunk == 1 else 16000)
    ref = fbank_cpu(wav)
    sf, jsf = StreamingFbank(), jdata.StreamingFbank()
    outs, pos = [], 0
    for c in _split(len(wav), chunk, np.random.default_rng(11)):
        piece = wav[pos : pos + c]
        pos += len(piece)
        out = sf.process(piece)
        np.testing.assert_array_equal(out, jsf.process(piece))
        outs.append(out)
    np.testing.assert_array_equal(np.concatenate(outs, axis=0), ref)


def test_streaming_fbank_reset_and_validation():
    sf = StreamingFbank()
    a = _wav(1, 2000)
    out1 = sf.process(a)
    sf.reset()
    out2 = sf.process(a)
    np.testing.assert_array_equal(out1, out2)
    assert sf.process(np.zeros(10, np.float32)).shape == (0, 80)
