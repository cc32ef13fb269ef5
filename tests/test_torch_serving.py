"""The port's continuous-batching server (fast_rnnt_tpu_torch.models.serving)
against the JAX package's server and against offline decoding, on the CPU.

Counterparts of tests/test_serving.py and a short form of
tests/test_serving_soak.py at their tiny float32 widths (vocab 12, 6
features, d_model 16, 2 layers, 2 heads, conv 7, attention left context
4), the JAX model's weights carried across by ``params_from_flax``.  Every
stream's tokens must equal, exactly, the JAX server's on the same schedule
and the port's and the JAX package's offline decode.  The reset test holds
every leaf bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_rnnt_tpu.models import StreamServer as JStreamServer
from fast_rnnt_tpu.models import StreamingConfig as JStreamingConfig
from fast_rnnt_tpu.models import greedy_search as jgreedy_search
from fast_rnnt_tpu.models import modified_beam_search as jbeam_search
from fast_rnnt_tpu_torch.models import (
    StreamServer,
    StreamingConfig,
    greedy_search,
    modified_beam_search,
    streaming_init,
    streaming_reset,
    streaming_step,
)

from ._torch_parity import STREAM_TINY, causal_models, pad_utts


def _utts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(L, STREAM_TINY["feature_dim"])).astype(np.float32) for L in lengths]


def _offline(jm, jp, model, utts, max_len, beam=0):
    """Per utterance, the port's offline tokens; they must equal the JAX
    package's."""
    feats, flens = pad_utts(utts)
    if beam:
        h, l = modified_beam_search(model, torch.tensor(feats), torch.tensor(flens), beam=beam,
                                    max_len=max_len)
        jh, jl = jax.jit(lambda p, f, n: jbeam_search(jm, p, f, n, beam=beam, max_len=max_len))(
            jp, jnp.asarray(feats), jnp.asarray(flens))
    else:
        h, l = greedy_search(model, torch.tensor(feats), torch.tensor(flens), max_len=max_len)
        jh, jl = jax.jit(lambda p, f, n: jgreedy_search(jm, p, f, n, max_len=max_len))(
            jp, jnp.asarray(feats), jnp.asarray(flens))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    h, l = h.numpy(), l.numpy()
    return {i: h[i, : l[i]] for i in range(len(utts))}


def _servers(jm, jp, model, capacity, **scfg):
    return (StreamServer(model, StreamingConfig(**scfg), capacity),
            JStreamServer(jm, jp, JStreamingConfig(**scfg), capacity))


def _assert_streams(got, jgot, want):
    assert set(got) == set(jgot) == set(want)
    for i in want:
        np.testing.assert_array_equal(got[i], jgot[i], err_msg=f"stream {i} vs the JAX server")
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"stream {i} vs offline")
        assert got[i].dtype == np.int32
    assert sum(len(t) for t in want.values()) > 0, "degenerate test: nothing was emitted"


@pytest.mark.parametrize("beam", [0, 2], ids=["greedy", "beam2"])
def test_server_matches_offline_with_slot_churn(beam):
    """Greedy: 7 ragged streams through 2 slots, every slot reused, streams
    admitted mid-run into slots at other positions (tests/test_serving.py:62).
    Beam 2: 3 streams through 2 slots (tests/test_serving.py:86)."""
    jm, jp, model = causal_models(beam // 2)
    lengths = [64, 32, 48] if beam else [96, 40, 64, 24, 88, 56, 32]
    utts = _utts(lengths, seed=beam // 2)
    max_len = 48 if beam else 64
    want = _offline(jm, jp, model, utts, max_len, beam)
    server, jserver = _servers(jm, jp, model, 2, chunk=16, max_len=max_len, beam=beam)
    for i, u in enumerate(utts):
        server.submit(i, u)
        jserver.submit(i, u)
    _assert_streams(server.run(), jserver.run(), want)


def test_feed_as_you_go_stream_is_exact():
    """final=False and extend(): audio in odd-sized pieces, sub-chunk stalls
    that freeze the slot while a neighbour decodes (tests/test_serving.py:112)."""
    jm, jp, model = causal_models(2)
    (utt,) = _utts([70], seed=2)
    (other,) = _utts([60], seed=3)
    want = _offline(jm, jp, model, [utt, other], 64)
    pieces = [utt[10:22], utt[22:23], utt[23:61], utt[61:]]
    results = []
    for srv in _servers(jm, jp, model, 2, chunk=16, max_len=64):
        srv.submit("live", utt[:10], final=False)
        srv.submit("other", other)
        done = {}
        for p in pieces:
            done.update(srv.step())
            srv.extend("live", p)
        srv.finish("live")
        done.update(srv.run())
        assert srv.idle and srv.active_streams == 0
        results.append({0 if k == "live" else 1: v for k, v in done.items()})
    _assert_streams(*results, want)


def test_run_raises_instead_of_spinning_on_open_stream():
    _, _, model = causal_models(3, num_layers=1)
    server = StreamServer(model, StreamingConfig(chunk=8, max_len=16), capacity=1)
    server.submit("open", np.zeros((4, STREAM_TINY["feature_dim"]), np.float32), final=False)
    assert server.active_streams == 1
    with pytest.raises(RuntimeError, match="final=False"):
        server.run()
    with pytest.raises(ValueError, match="features must be"):
        server.submit("bad", np.zeros((4, 5), np.float32))
    with pytest.raises(ValueError, match="at least one frame"):
        server.submit("empty", np.zeros((0, STREAM_TINY["feature_dim"]), np.float32))


def test_streaming_reset_restores_fresh_state_per_slot():
    """After three chunks, resetting slot 0 gives streaming_init's leaves
    there bit for bit and leaves slot 1 as it was (tests/test_serving.py:195);
    the reset slot then decodes as a fresh batch does."""
    _, _, model = causal_models(4, num_layers=1)
    scfg = StreamingConfig(chunk=8, max_len=16)
    B = 2
    rng = np.random.default_rng(4)
    state = streaming_init(model, scfg, B)
    for _ in range(3):
        fc = torch.tensor(rng.normal(size=(B, 8, STREAM_TINY["feature_dim"])).astype(np.float32))
        state, _ = streaming_step(model, scfg, state, fc, torch.full((B,), 8, dtype=torch.int32))
    out = streaming_reset(model, scfg, state, torch.tensor([True, False]))
    fresh = streaming_init(model, scfg, B)

    def leaves(st, path=""):
        for k, v in st.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}{k}.")
            elif isinstance(v, list):
                for i, x in enumerate(v):
                    yield f"{path}{k}.{i}", x
            else:
                yield f"{path}{k}", v

    flat_out, flat_fresh, flat_old = (dict(leaves(s)) for s in (out, fresh, state))
    assert flat_out.keys() == flat_fresh.keys() == flat_old.keys()
    for key, leaf in flat_out.items():
        assert torch.equal(leaf[0], flat_fresh[key][0]), f"slot 0 not fresh at {key}"
        assert torch.equal(leaf[1], flat_old[key][1]), f"slot 1 was disturbed at {key}"
    assert any(not torch.equal(v[1], flat_fresh[k][1]) for k, v in flat_out.items())

    fc = torch.tensor(rng.normal(size=(B, 8, STREAM_TINY["feature_dim"])).astype(np.float32))
    lens = torch.full((B,), 8, dtype=torch.int32)
    _, (h, l) = streaming_step(model, scfg, out, fc, lens)
    _, (fh, fl) = streaming_step(model, scfg, fresh, fc, lens)
    assert torch.equal(h[0], fh[0]) and torch.equal(l[0], fl[0])


def test_serving_soak_short():
    """A short form of tests/test_serving_soak.py:53: 12 random-length
    streams with exponential arrival gaps, every 4th held open and fed in
    odd pieces, through 3 slots; the same schedule goes to the JAX server
    and to the port's, and every stream finishes with the same tokens."""
    rng = np.random.default_rng(0)
    jm, jp, model = causal_models(0)
    N, capacity, chunk = 12, 3, 16
    lengths = rng.integers(8, 121, size=N)
    utts = [rng.normal(size=(L, STREAM_TINY["feature_dim"])).astype(np.float32) for L in lengths]
    want = _offline(jm, jp, model, utts, 64)
    arrivals = np.floor(np.cumsum(rng.exponential(1.5, size=N))).astype(int)
    open_ids = [i for i in range(N) if i % 4 == 3]
    pieces = {}
    for i in open_ids:
        cuts = np.unique(rng.integers(1, len(utts[i]), size=min(3, len(utts[i]) - 1)))
        pieces[i] = list(np.split(utts[i], cuts))
    budget = 4 * (int(sum(-(-len(u) // chunk) for u in utts)) + N
                  + sum(map(len, pieces.values()))) + 50

    results = []
    for srv in _servers(jm, jp, model, capacity, chunk=chunk, max_len=64):
        done, steps, nxt, finished = {}, 0, 0, set()
        remaining = {i: list(p) for i, p in pieces.items()}
        while len(done) < N:
            assert steps < budget, f"{len(done)}/{N} streams done after {steps} steps"
            while nxt < N and arrivals[nxt] <= steps:
                if nxt in pieces:
                    srv.submit(nxt, remaining[nxt].pop(0), final=False)
                else:
                    srv.submit(nxt, utts[nxt])
                nxt += 1
            for i in open_ids:
                if i < nxt and i not in finished and steps % 3 == 0:
                    if remaining[i]:
                        srv.extend(i, remaining[i].pop(0))
                    else:
                        srv.finish(i)
                        finished.add(i)
            done.update(srv.step())
            steps += 1
        assert srv.idle
        results.append(done)
    _assert_streams(*results, want)


def test_torch_streaming_example_runs_on_the_cpu(capsys):
    """examples/torch_streaming_decode.py with ``--device cpu``: its
    streamed and served tokens equal its offline decode (it raises
    otherwise)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_streaming_decode.py"
    spec = importlib.util.spec_from_file_location("torch_streaming_decode", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--steps", "20"])
    assert "StreamServer (1 slot, 3 admissions) == offline decode" in capsys.readouterr().out
