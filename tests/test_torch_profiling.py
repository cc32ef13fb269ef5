"""The port's timing and profiling helpers
(``fast_rnnt_tpu_torch/utils/profiling.py``) on the CPU: the slope
estimator cancels a per-run constant, the carried step chains its carry,
the memory figures' sizes equal the JAX module's on the same shapes, the
trace holds an annotated span, and the collective census counts a gloo
group's collectives, on one rank in this process and on the two-rank
``make_train_step`` (worker processes of ``tests._torch_mp_worker``).

Tolerance: the 2 ms step is timed to +-1 ms (the host's sleep overshoots
by up to a few hundred microseconds under load; the 50 ms constant is
what must cancel).
"""

import glob
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fast_rnnt_tpu.utils.profiling import compiled_memory_mb as jcompiled_memory_mb
from fast_rnnt_tpu_torch.utils import (
    annotate,
    benchmark_fn,
    benchmark_on_device,
    collective_census,
    compiled_memory_mb,
    device_memory_stats,
    trace_to,
)
from fast_rnnt_tpu_torch.utils.profiling import benchmark_carried_on_device

from . import _torch_mp_worker as W

STEP_S, SETUP_S = 2e-3, 50e-3


def test_benchmark_on_device_cancels_a_per_run_constant():
    def setup(i, x):
        if i == 0:  # once a run: the constant the estimator must cancel
            time.sleep(SETUP_S)
        return (x,)

    s = benchmark_on_device(lambda x: time.sleep(STEP_S), torch.ones(3), iters=10, trials=3,
                            perturb=setup)
    assert abs(s - STEP_S) <= 1e-3, s


def test_benchmark_on_device_default_passes_args_unchanged():
    seen = []
    x = torch.arange(3.0)
    benchmark_on_device(lambda a: seen.append(a), x, iters=2, trials=1)
    assert len(seen) == 3 * 2 + 2 + 2 * 3 and all(a is x for a in seen)


def test_benchmark_carried_on_device_chains_its_carry():
    seen = []

    def step(c, inc):
        seen.append(int(c))
        return c + inc

    s = benchmark_carried_on_device(step, torch.tensor(0), torch.tensor(1), iters=2, trials=2)
    assert s >= 0.0
    # warm-up of 6 steps, then runs of 2 and 6 steps twice, each from the carry given
    runs = [6, 2, 6, 2, 6]
    want = [i for n in runs for i in range(n)]
    assert seen == want


# XLA's output size also counts the output tuple's table of buffer
# pointers, 8 bytes an element, which has no counterpart in eager torch
XLA_TUPLE_ENTRY_BYTES = 8


@pytest.mark.parametrize("tupled", [False, True], ids=["one-output", "three-outputs"])
def test_compiled_memory_mb_sizes_equal_the_jax_ones(tupled):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 48)).astype(np.float32)
    b = rng.normal(size=(48, 40)).astype(np.float32)
    idx = np.arange(7, dtype=np.int32)

    def torch_fn(x, y, i):
        z = x @ y
        return (z, z[i].sum(dim=1), x.to(torch.bfloat16)) if tupled else z[i]

    def jax_fn(x, y, i):
        z = x @ y
        return (z, z[i].sum(axis=1), x.astype(jnp.bfloat16)) if tupled else z[i]

    got = compiled_memory_mb(torch_fn, *(torch.from_numpy(v) for v in (a, b, idx)))
    want = jcompiled_memory_mb(jax_fn, *(jnp.asarray(v) for v in (a, b, idx)))
    assert set(got) == {"argument_mb", "output_mb"}  # no device peak on the CPU
    table = 3 * XLA_TUPLE_ENTRY_BYTES / 2**20 if tupled else 0.0
    assert got["argument_mb"] == want["argument_mb"]
    assert got["output_mb"] + table == pytest.approx(want["output_mb"], rel=1e-12)


def test_device_memory_stats_is_empty_on_the_cpu():
    assert device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def test_benchmark_fn_times_the_host():
    s = benchmark_fn(lambda: time.sleep(STEP_S), iters=20, warmup=1)
    assert STEP_S <= s <= STEP_S + 1e-3


def test_trace_holds_the_annotated_span(tmp_path):
    with trace_to(str(tmp_path)) as prof:
        with annotate("train_step"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "train_step" in names and "aten::mm" in names
    assert any(e.name == "train_step" for e in prof.events())


def _one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)


def test_collective_census_on_one_rank(tmp_path):
    T = 64
    _one_rank_group(tmp_path)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    record_shapes=True) as prof:
            dist.all_reduce(torch.ones(4, 10))
            dist.all_reduce(torch.ones(()))  # a scalar: its shape is []
            dist.all_gather([torch.empty(2, T + 1)], torch.ones(2, T + 1))
            dist.broadcast(torch.ones(3), 0)
        census = collective_census(prof, lattice_dims=(T, T + 1))
        assert {k: v for k, v in census.items() if k != "lattice_moves"} == {
            "all-reduce": 2, "all-gather": 1, "all-to-all": 0, "collective-permute": 0,
            "reduce-scatter": 0, "broadcast": 1}
        assert len(census["lattice_moves"]) == 1
        assert census["lattice_moves"][0].startswith("gloo:all_gather")
        assert collective_census(prof.events())["lattice_moves"] == []  # no dims, no moves

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as bare:
            dist.all_reduce(torch.ones(4, 10))
        with pytest.raises(ValueError, match="record_shapes"):
            collective_census(bare)
    finally:
        dist.destroy_process_group()


def test_collective_census_names():
    from fast_rnnt_tpu_torch.utils.profiling import _collective_kind

    assert _collective_kind("nccl:all_reduce") == "all-reduce"
    assert _collective_kind("nccl:_allgather_base") == "all-gather"
    assert _collective_kind("nccl:all_gather_into_tensor_coalesced") == "all-gather"
    assert _collective_kind("nccl:_reduce_scatter_base") == "reduce-scatter"
    assert _collective_kind("gloo:all_to_all") == "all-to-all"
    assert _collective_kind("nccl:send 0->1") == "collective-permute"
    assert _collective_kind("gloo:recv") == "collective-permute"
    assert _collective_kind("gloo:barrier") is None
    assert _collective_kind("c10d::allreduce_") is None
    assert _collective_kind("aten::add") is None


@pytest.mark.multiprocess
def test_collective_census_of_the_two_rank_train_step(tmp_path):
    """Three all-reduces a step: the gradient buffer (every parameter, one
    float32 buffer), the float metrics (loss, simple_loss, pruned_loss) and
    the integer frame count, which ``all_reduce_sum`` buckets apart by
    dtype; no other collective, and none of a lattice-sized tensor."""
    from .test_torch_parallel import run_ranks

    steps = 2
    outs = run_ranks("census", tmp_path, seed=0, steps=steps)
    cfg = W.TransducerConfig(dtype=torch.float32, **W.TRAIN_CFG)
    n_params = sum(p.numel() for p in W.init_model(cfg, device="cpu").parameters())
    for out in outs:
        census = out["census"]
        assert census["all-reduce"] == 3 * steps
        assert all(census[k] == 0 for k in ("all-gather", "all-to-all", "collective-permute",
                                            "reduce-scatter", "broadcast"))
        assert census["lattice_moves"] == []
        assert out["shapes"] == [[[n_params]], [[3]], [[1]]] * steps
