"""The port's data parallelism (``fast_rnnt_tpu_torch.parallel`` and
``make_train_step(..., mesh)``) on two gloo ranks on the CPU, against the
JAX package over two of the eight virtual CPU devices and against the
port's own single-process results.

Each multiprocess test starts two ``tests._torch_mp_worker`` processes
(torch only) that meet through a ``file://`` store in ``tmp_path``; a rank
that fails or hangs past the timeout fails the test.  The JAX side runs
here, in the parent.  Tolerances: tests/test_parallel.py's for the
sharded loss and value_and_grad; the two-rank step's gradients equal the
sum of the two shards' single-process gradients bit for bit (a SUM of two
tensors is exact); against the JAX mesh step, tests/test_torch_models.py's:
loss rel 1e-4 and gradients within 1e-4 of the model's largest gradient."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_rnnt_tpu import data as jdata
from fast_rnnt_tpu import rnnt_loss_simple as jrnnt_loss_simple
from fast_rnnt_tpu.csrc import fbank_cpu as jfbank_cpu
from fast_rnnt_tpu.models import LossConfig as JLossConfig
from fast_rnnt_tpu.models import TransducerConfig as JConfig
from fast_rnnt_tpu.models import init_model as jinit_model
from fast_rnnt_tpu.models import make_train_step as jmake_train_step
from fast_rnnt_tpu.models.training import make_boundary as jmake_boundary
from fast_rnnt_tpu.models.training import pruned_transducer_loss as jloss_fn
from fast_rnnt_tpu.ops.pruning import get_rnnt_prune_ranges as jget_ranges
from fast_rnnt_tpu.parallel import data_parallel as jdata_parallel
from fast_rnnt_tpu.parallel import data_parallel_value_and_grad as jdp_value_and_grad
from fast_rnnt_tpu.parallel import make_mesh as jmake_mesh
from fast_rnnt_tpu.parallel import shard_batch as jshard_batch
from fast_rnnt_tpu_torch.data import RaggedBatcher, fbank_cpu
from fast_rnnt_tpu_torch.parallel import (
    DATA_AXIS,
    batch_sharding,
    data_parallel,
    data_parallel_value_and_grad,
    initialize_distributed,
    make_mesh,
    shard_batch,
)
from fast_rnnt_tpu_torch.parallel.sharding import LocalMesh
from fast_rnnt_tpu_torch.utils import params_from_flax

from . import _torch_mp_worker as W
from ._torch_parity import assert_ranges_match, to_np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT_S = 180
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4  # of the model's largest gradient
S_RANGE = 3


def run_ranks(case, tmp_path, **spec):
    """Run ``case`` on two worker ranks; returns each rank's saved dict."""
    (tmp_path / "spec.json").write_text(json.dumps({**spec, "dir": str(tmp_path)}))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests._torch_mp_worker", case, str(r), str(WORLD), str(tmp_path)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: a rank did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{case} rank {r} exited {p.returncode}:\n{log[-3000:]}"
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]


def cat(outs, key):
    return np.concatenate([to_np(o[key]) for o in outs])


# --- one process: the one-rank mesh ------------------------------------------

def test_local_mesh_without_a_group():
    """No process group: make_mesh gives a one-rank mesh whose collectives
    return their inputs; initialize_distributed is a no-op single-process."""
    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    mesh = make_mesh("cpu")
    assert isinstance(mesh, LocalMesh)
    assert (mesh.size(), mesh.get_local_rank(), mesh.get_group(), mesh.mesh_dim_names) == (
        1, 0, None, (DATA_AXIS,))
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    (got, s) = shard_batch((x, np.int32(4)), mesh)
    assert torch.equal(got, torch.from_numpy(x)) and s.ndim == 0 and int(s) == 4
    got[0, 0] = 99.0  # a copy: the caller's array is untouched
    assert x[0, 0] == 0.0
    assert batch_sharding(mesh).local_slice(3) == slice(0, 3)
    with pytest.raises(ValueError, match="mesh axes"):
        batch_sharding(mesh, "model")

    lm, am, symbols, boundary = (torch.from_numpy(a) for a in W.loss_inputs(0))
    from fast_rnnt_tpu_torch import rnnt_loss_simple

    def loss_fn(params, lm, am, symbols, boundary):
        return rnnt_loss_simple(lm * params["w_lm"], am, symbols, 0, boundary, reduction="sum")

    params = {"w_lm": torch.ones(lm.shape[2])}
    loss, grads = data_parallel_value_and_grad(loss_fn, mesh)(params, lm, am, symbols, boundary)
    w = params["w_lm"].clone().requires_grad_()
    ref = loss_fn({"w_lm": w}, lm, am, symbols, boundary)
    ref.backward()
    assert torch.equal(loss, ref.detach()) and torch.equal(grads["w_lm"], w.grad)
    out = data_parallel(lambda a: a.sum(), mesh, reduce_outputs=True)(am)
    assert torch.equal(out, am.sum())


def test_make_mesh_cuda_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_initialize_distributed_propagates_errors():
    """A failed initialisation raises instead of leaving the rank to train
    alone."""
    with pytest.raises(RuntimeError, match="rendezvous"):
        initialize_distributed("bogus://nowhere", 2, 0, device="cpu")
    assert not torch.distributed.is_initialized()


# --- two ranks ---------------------------------------------------------------

@pytest.mark.multiprocess
def test_sharded_loss_and_value_and_grad_match_jax(tmp_path):
    """shard_batch, data_parallel (local and SUM-reduced outputs) and
    data_parallel_value_and_grad on two ranks against the JAX package's
    over a 2-device mesh, at tests/test_parallel.py's tolerances."""
    outs = run_ranks("sharding", tmp_path, seed=0)
    lm, am, symbols, boundary = W.loss_inputs(0)
    for r, o in enumerate(outs):
        for got, want in zip(o["shard"][:4], (lm, am, symbols, boundary)):
            np.testing.assert_array_equal(to_np(got), want[r * 4 : (r + 1) * 4])
        assert float(o["shard"][4]) == 2.5 and o["shard"][4].ndim == 0
        assert o["indivisible_raised"]

    mesh = jmake_mesh(jax.devices()[:WORLD])
    jargs = jshard_batch(tuple(jnp.asarray(a) for a in (lm, am, symbols, boundary)), mesh)

    def jloss(reduction):
        return lambda lm, am, s, b: jrnnt_loss_simple(lm, am, s, 0, b, reduction=reduction)

    want = np.asarray(jdata_parallel(jloss("none"), mesh)(*jargs))
    np.testing.assert_allclose(cat(outs, "none"), want, rtol=1e-5, atol=1e-5)
    want_sum = float(jdata_parallel(jloss("sum"), mesh, reduce_outputs=True)(*jargs))
    for o in outs:
        np.testing.assert_allclose(float(o["sum"]), want_sum, rtol=1e-4)

    def jvg_loss(params, lm, am, s, b):
        return jrnnt_loss_simple(lm * params["w_lm"], am * params["w_am"], s, 0, b, reduction="sum")

    params = {"w_am": jnp.ones((am.shape[2],)), "w_lm": jnp.ones((lm.shape[2],))}
    jl, jg = jdp_value_and_grad(jvg_loss, mesh)(params, *jargs)
    for o in outs:
        np.testing.assert_allclose(float(o["vg_loss"]), float(jl), rtol=1e-4)
        for k in params:
            np.testing.assert_allclose(to_np(o["vg_grads"][k]), np.asarray(jg[k]), rtol=1e-3, atol=1e-4)
    for k in params:  # the same SUM on both ranks
        assert torch.equal(outs[0]["vg_grads"][k], outs[1]["vg_grads"][k])


@pytest.mark.multiprocess
def test_two_rank_train_step_equals_shard_sum(tmp_path):
    """The all-reduced gradients equal the two shards' single-process
    gradients added, bit for bit; the metrics are the shards' sums; both
    ranks take the same optimizer step."""
    outs = run_ranks("train", tmp_path, seed=0)
    for o in outs:
        assert o["grads"].keys() == o["shard_sum"].keys()
        for name, g in o["grads"].items():
            assert torch.equal(g, o["shard_sum"][name]), name
        for k, v in o["metrics"].items():
            assert torch.equal(v, o["shard_metrics_sum"][k].to(v.dtype)), k
    for name, p in outs[0]["params"].items():
        assert torch.equal(p, outs[1]["params"][name]), name
        assert torch.equal(outs[0]["grads"][name], outs[1]["grads"][name]), name


def _jax_ranges(model, params, batch, s_range):
    feats, flens, syms, slens = (jnp.asarray(x) for x in batch)
    _, _, s_am, s_lm, out_lens = model.apply(params, feats, flens, syms)
    bnd = jmake_boundary(out_lens, slens)
    _, (gx, gy) = jrnnt_loss_simple(s_lm, s_am, syms, 0, bnd, reduction="sum", calc_gradients=True)
    return np.asarray(jget_ranges(gx, gy, bnd, s_range)), (gx, gy)


@pytest.mark.multiprocess
def test_audio_to_two_rank_train_step_matches_jax(tmp_path):
    """Synthetic waveforms through fbank_cpu and RaggedBatcher (pad_batch_to
    8: one empty utterance), then the port's two-rank make_train_step from
    the JAX model's weights, against the JAX make_train_step on a 2-device
    mesh over the same batch: metrics to rel 1e-4, every gradient within
    1e-4 of the model's largest.  Stage 2 of both runs on the JAX ranges;
    the port's own ranges must equal them but for near-ties."""
    seed = 3
    batch = W.slice_batch(jfbank_cpu, jdata.RaggedBatcher, seed)
    port_batch = W.slice_batch(fbank_cpu, RaggedBatcher, seed)
    for a, b in zip(port_batch, batch):
        np.testing.assert_array_equal(a, b)
    assert batch[0].shape[0] == W.SLICE_PAD_TO and (batch[1] == 0).sum() == 1

    jm, jp = jinit_model(jax.random.PRNGKey(0), JConfig(dtype=jnp.float32, **W.SLICE_CFG))
    jp = jax.device_get(jp)
    torch.save(params_from_flax(jp), tmp_path / "weights.pt")
    ranges, (gx, gy) = _jax_ranges(jm, jp, batch, S_RANGE)
    np.save(tmp_path / "ranges.npy", ranges)

    outs = run_ranks("slice", tmp_path, seed=seed, s_range=S_RANGE)

    mesh = jmake_mesh(jax.devices()[:WORLD])
    loss_cfg = JLossConfig(s_range=S_RANGE)
    jstep = jmake_train_step(jm, optax.adamw(1e-3), mesh=mesh, loss_cfg=loss_cfg)
    jbatch = jshard_batch(tuple(jnp.asarray(x) for x in batch), mesh)
    _, _, jmetrics = jstep(jp, optax.adamw(1e-3).init(jp), jbatch)
    jgrads, _ = jax.jit(jax.grad(lambda p, b: jloss_fn(p, jm, *b, loss_cfg), has_aux=True))(
        jp, tuple(jnp.asarray(x) for x in batch))
    want = params_from_flax(jax.device_get(jgrads))
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())

    own = np.concatenate([to_np(o["own_ranges"]) for o in outs])
    from fast_rnnt_tpu_torch.ops.pruning import _window_scores

    scores = _window_scores(torch.tensor(np.asarray(gx)).movedim(1, 0),
                            torch.tensor(np.asarray(gy)).movedim(1, 0), S_RANGE)
    assert_ranges_match(own[:, :, 0], ranges[:, :, 0], to_np(scores), "port ranges")
    for r, o in enumerate(outs):
        for got, x in zip(o["batch"], batch):
            np.testing.assert_array_equal(to_np(got), x[r * 4 : (r + 1) * 4])
        for key in ("loss", "simple_loss", "pruned_loss"):
            w = float(jmetrics[key])
            assert abs(float(o["metrics"][key]) - w) <= LOSS_RTOL * abs(w), (key, float(o["metrics"][key]), w)
        assert int(o["metrics"]["frames"]) == int(jmetrics["frames"])
        assert o["grads"].keys() == want.keys()
        for name, g in o["grads"].items():
            err = np.abs(to_np(g) - want[name].numpy()).max()
            assert err <= GRAD_TOL * top, f"{name}: {err} vs {GRAD_TOL} x {top}"


@pytest.mark.multiprocess
def test_sharded_server_step_matches_single_process(tmp_path):
    """The counterpart of tests/test_serving.py's sharded server step:
    streaming_reset + streaming_step under data_parallel over two ranks
    give the single-process tokens exactly and every state leaf bit for
    bit."""
    outs = run_ranks("serve", tmp_path, seed=5)
    model, scfg, state, step_in = W.serve_setup(5)
    ref_state, (ref_hyps, ref_lens) = W.serve_fn(model, scfg)(state, *step_in)
    np.testing.assert_array_equal(cat(outs, "hyps"), ref_hyps.numpy())
    np.testing.assert_array_equal(cat(outs, "lens"), ref_lens.numpy())
    from fast_rnnt_tpu_torch.parallel.sharding import _leaves

    got = [_leaves(o["state"]) for o in outs]
    want = _leaves(ref_state)
    assert len(got[0]) == len(want)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(np.concatenate([to_np(g[i]) for g in got]), to_np(w))


def test_train_and_decode_example_resumes(tmp_path):
    """examples/torch_train_and_decode.py on the CPU: 4 steps with a
    checkpoint, then a resume from it to step 6; both exit 0."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, str(ROOT / "examples" / "torch_train_and_decode.py"), "--device", "cpu",
           "--ckpt", str(tmp_path / "ckpt")]
    outs = []
    for steps in (4, 6):
        res = subprocess.run(cmd + ["--steps", str(steps)], env=env, capture_output=True, text=True,
                             timeout=TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-3000:]
        outs.append(res.stdout)
    assert "resumed" not in outs[0] and "resumed from step 4" in outs[1]
    for steps, out in zip((4, 6), outs):
        last = json.loads(out.strip().splitlines()[-1])
        assert last["steps"] == steps and last["ranks"] == 1
        assert 0.0 <= last["greedy_accuracy"] <= 1.0 and 0.0 <= last["beam_accuracy"] <= 1.0
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["4", "6"]
