"""The port's spans (``fast_rnnt_tpu_torch/ops/kernels/partition.py``):
every call of a public op is a ``frt.<op>`` span of the profiler's
timeline, nested as the calls nest, on plain tensors and on DTensors
alike; the kernel wrappers open none; and with no profiler running a call
enters no ``record_function`` at all."""

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from torch.profiler import ProfilerActivity, profile

import fast_rnnt_tpu_torch as frt
import fast_rnnt_tpu_torch.ops as tops
from fast_rnnt_tpu_torch.ops.kernels import wavefront
from fast_rnnt_tpu_torch.utils import annotate

from . import _torch_mp_worker as W

# the recipe at a tiny shape
B, T, S, C, K = 2, 10, 4, 6, 3


def recipe_inputs():
    g = torch.Generator().manual_seed(0)
    am = torch.randn(B, T, C, generator=g, requires_grad=True)
    lm = torch.randn(B, S + 1, C, generator=g, requires_grad=True)
    sym = torch.randint(1, C, (B, S), generator=g)
    bnd = torch.tensor([[0, 0, S, T], [0, 0, S - 1, T - 2]])
    return am, lm, sym, bnd


def recipe_step(am, lm, sym, bnd):
    """icefall's unfused pipeline: the smoothed loss with occupancies, the
    ranges, the pruning, the caller's joiner add, the pruned loss, and the
    gradients of the weighted sum."""
    simple, (gx, gy) = frt.rnnt_loss_smoothed(lm, am, sym, 0, lm_only_scale=0.25,
                                              am_only_scale=0.0, boundary=bnd,
                                              reduction="none", calc_gradients=True)
    ranges = frt.get_rnnt_prune_ranges(gx, gy, bnd, K)
    am_p, lm_p = frt.do_rnnt_pruning(am, lm, ranges)
    pruned = frt.rnnt_loss_pruned(am_p + lm_p, sym, ranges, 0, bnd, reduction="none")
    return torch.autograd.grad(0.5 * simple.sum() + pruned.sum(), (am, lm))


def cpu_profile(fn, *args, **kwargs):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args, **kwargs)
    return prof.events()


def enclosing_span(e):
    """The nearest ``frt.*`` event above ``e``, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("frt."):
        p = p.cpu_parent
    return p


def outermost_spans(events):
    return [e.name for e in events if e.name.startswith("frt.") and enclosing_span(e) is None]


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered")


@pytest.fixture
def no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)


def test_no_profiler_enters_no_record_function(no_record_function):
    am, lm, sym, bnd = recipe_inputs()
    assert not torch._C._autograd._profiler_enabled()
    simple, pruned, _ = frt.rnnt_loss_simple_pruned(lm, am, sym, 0, K, bnd, reduction="none")
    torch.autograd.grad(simple.sum() + pruned.sum(), (am, lm))
    recipe_step(am, lm, sym, bnd)
    with annotate("train_step"):
        pass


def test_profiler_enters_record_function(no_record_function):
    """The test above is not vacuous: under a profiler the same call opens
    its span through a ``RecordFunction``."""
    am, lm, sym, bnd = recipe_inputs()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function entered"):
            frt.rnnt_loss_simple_pruned(lm, am, sym, 0, K, bnd, reduction="none")


@pytest.fixture(scope="module")
def recipe_events():
    return cpu_profile(recipe_step, *recipe_inputs())


@pytest.mark.parametrize("outer,inner", [
    ("frt.rnnt_loss_pruned", "frt.get_rnnt_logprobs_pruned"),
    ("frt.rnnt_loss_smoothed", "frt.get_rnnt_logprobs_smoothed_rows"),
    ("frt.rnnt_loss_smoothed", "frt.mutual_information_rows"),
    ("frt.rnnt_loss_pruned", "frt.mutual_information_recursion"),
    ("frt.get_rnnt_prune_ranges", "frt.get_rnnt_prune_ranges_rows"),
    (None, "frt.do_rnnt_pruning"),
], ids=lambda x: str(x).removeprefix("frt."))
def test_recipe_spans_nest(recipe_events, outer, inner):
    """Each public call is its span, inside the span of the public call that
    made it (or of none) and within its time range."""
    def name(e):
        return e.name if e is not None else None

    found = [e for e in recipe_events if e.name == inner and name(enclosing_span(e)) == outer]
    assert len(found) == 1, [(e.name, name(enclosing_span(e))) for e in recipe_events
                             if e.name.startswith("frt.")]
    parent = enclosing_span(found[0])
    if parent is not None:
        assert parent.time_range.start <= found[0].time_range.start
        assert found[0].time_range.end <= parent.time_range.end


def test_recipe_has_no_other_outermost_span(recipe_events):
    assert outermost_spans(recipe_events) == [
        "frt.rnnt_loss_smoothed", "frt.get_rnnt_prune_ranges", "frt.do_rnnt_pruning",
        "frt.rnnt_loss_pruned"]


@pytest.fixture(scope="module")
def arrays():
    return W.partition_arrays(0)


@pytest.mark.parametrize("name", sorted(W.ENTRIES))
def test_public_op_is_one_span(arrays, name):
    """Every partitioned public op is one outermost span named after it,
    and every span inside it is a public op's: no kernel wrapper opens one."""
    fname, _, kw = W.ENTRIES[name]
    fn = W.entry_function(tops, fname)
    args = W.entry_args(name, arrays, lambda a, x: torch.from_numpy(x))
    events = cpu_profile(fn, *args, **kw)
    assert outermost_spans(events) == [f"frt.{name}"]
    public = {f"frt.{n}" for n in W.ENTRIES}
    assert {e.name for e in events if e.name.startswith("frt.")} <= public


def test_kernel_wrapper_opens_no_span(arrays):
    px, py = (torch.from_numpy(arrays[k]) for k in ("px_rows", "py_rows"))
    events = cpu_profile(wavefront.forward_rows, px, py, torch.from_numpy(arrays["boundary"]))
    assert not [e.name for e in events if e.name.startswith("frt.")]


@pytest.fixture
def one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["rnnt_loss_simple_pruned", "do_rnnt_pruning",
                                  "get_rnnt_logprobs_rows"])
def test_dtensor_call_is_one_span(arrays, one_rank_mesh, name):
    """On Shard(0) DTensors of a one-rank mesh the call is its span too, and
    the unwrapping of the arguments and the wrapping of the results fall
    inside it."""
    fname, _, kw = W.ENTRIES[name]
    args = W.entry_args(name, arrays, lambda a, x: DTensor.from_local(
        torch.from_numpy(x), one_rank_mesh, [Shard(1) if a.endswith("_rows") else Shard(0)]))
    events = cpu_profile(getattr(tops, fname), *args, **kw)
    assert outermost_spans(events) == [f"frt.{name}"]
    moves = [e for e in events if e.name in ("_ToTorchTensor", "_FromTorchTensor")]
    assert {e.name for e in moves} == {"_ToTorchTensor", "_FromTorchTensor"}
    assert all(enclosing_span(e) is not None for e in moves)
