"""The attribution of perfbench/spans.py on the CPU: the recipe at a tiny
shape under a CPU profiler, each host operation's self time standing in for
the device work it would launch; and the link from a device event to the
operation that launched it, on events made by hand."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fast_rnnt_tpu_torch as frt
from fast_rnnt_tpu_torch.ops.kernels import partition
from perfbench import spans

B, T, S, C, K = 2, 10, 4, 6, 3


def recipe_step():
    g = torch.Generator().manual_seed(0)
    am = torch.randn(B, T, C, generator=g, requires_grad=True)
    lm = torch.randn(B, S + 1, C, generator=g, requires_grad=True)
    sym = torch.randint(1, C, (B, S), generator=g)
    bnd = torch.tensor([[0, 0, S, T], [0, 0, S - 1, T - 2]])
    simple, (gx, gy) = frt.rnnt_loss_smoothed(lm, am, sym, 0, lm_only_scale=0.25,
                                              am_only_scale=0.0, boundary=bnd,
                                              reduction="none", calc_gradients=True)
    ranges = frt.get_rnnt_prune_ranges(gx, gy, bnd, K)
    am_p, lm_p = frt.do_rnnt_pruning(am, lm, ranges)
    pruned = frt.rnnt_loss_pruned(am_p + lm_p, sym, ranges, 0, bnd, reduction="none")
    total = 0.5 * simple.sum() + pruned.sum()
    # the simple-pruned entry too, for the plain build's span
    s2, p2, _ = frt.rnnt_loss_simple_pruned(lm, am, sym, 0, K, bnd, reduction="none")
    return torch.autograd.grad(total + s2.sum() + p2.sum(), (am, lm))


@pytest.fixture(scope="module")
def named():
    recipe_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recipe_step()
    return spans.Spans(prof.events())


def layer(named, e):
    return spans.layer_of(named.span(e))


def forward_op(named, name, span):
    """The one forward operation ``name`` directly under the layers of
    ``span``, and the backward node that its autograd node ran as."""
    ops = [e for e in named.host if e.name == name and named.span(e) == span
           and e.sequence_nr >= 0 and not named._in_backward(e)]
    assert ops, name
    op = ops[-1]
    nodes = [e for e in named.host if e.name.startswith(spans.BACKWARD)
             and (e.fwd_thread, e.sequence_nr) == (op.thread, op.sequence_nr)]
    return op, nodes


@pytest.mark.parametrize("op,span,want,node", [
    ("aten::index", "frt.do_rnnt_pruning", "pruning", "IndexBackward0"),
    ("aten::gather", "frt.get_rnnt_logprobs_pruned", "pruned_lattice", "GatherBackward0"),
    ("aten::logsumexp", "frt.get_rnnt_logprobs_pruned", "pruned_lattice", "LogsumexpBackward0"),
    ("aten::gather", "frt.get_rnnt_logprobs_smoothed_rows", "build", "GatherBackward0"),
    ("aten::add", None, "caller", "AddBackward0"),
], ids=["index-pruning", "gather-pruned_lattice", "logsumexp-pruned_lattice", "gather-build",
        "add-caller"])
def test_forward_op_and_its_backward_go_to_the_layer(named, op, span, want, node):
    """An operation goes to the layer of its span, and the backward node it
    made, with every operation the node runs, to the same layer."""
    fwd, nodes = forward_op(named, op, span)
    assert layer(named, fwd) == want
    assert len(nodes) == 1 and nodes[0].name.endswith(node), [n.name for n in nodes]
    inside = [e for e in named.host if e.time_range.start >= nodes[0].time_range.start
              and e.time_range.end <= nodes[0].time_range.end and e.thread == nodes[0].thread]
    assert inside and {layer(named, e) for e in inside} == {want}


def test_logsumexp_backward_goes_to_the_pruned_lattice(named):
    nodes = [e for e in named.host if e.name == f"{spans.BACKWARD}: LogsumexpBackward0"]
    assert nodes and {layer(named, e) for e in nodes} == {"pruned_lattice"}


def test_every_self_time_is_assigned_once(named):
    work = [(e, e.self_cpu_time_total * 1e-6) for e in named.host]
    split, unknown = named.split(work)
    assert set(split) == set(spans.ORDER) and unknown == 0.0
    assert split["pruning"] > 0 and split["pruned_lattice"] > 0 and split["caller"] > 0
    assert sum(split.values()) == pytest.approx(sum(s for _, s in work), rel=1e-12)
    # the outermost events' durations hold every self time once
    top = sum(e.time_range.elapsed_us() * 1e-6 for e in named.host if e.cpu_parent is None)
    assert sum(split.values()) == pytest.approx(top, rel=1e-9)


def test_host_seconds_are_the_programs(named):
    """The outermost spans and the backward nodes that belong to them: less
    than everything the step did on the host, more than the spans alone."""
    spans_s = sum(e.time_range.elapsed_us() * 1e-6 for e in named.host
                  if e.name.startswith(spans.PREFIX) and e.cpu_parent is None)
    top = sum(e.time_range.elapsed_us() * 1e-6 for e in named.host if e.cpu_parent is None)
    host, runtime = named.host_seconds()
    assert spans_s < host < top and runtime == 0.0


def test_layer_table_names_public_ops(named):
    """Every span of the table is the span of a wrapped public op of the port,
    and the recipe opens each of them but the (B, S, T)-major builds."""
    for span in spans.LAYERS:
        op = span.removeprefix(spans.PREFIX)
        assert op in frt.__all__ and hasattr(getattr(frt, op), "__wrapped__"), span
    seen = {e.name for e in named.host if e.name.startswith(spans.PREFIX)}
    assert set(spans.LAYERS) - seen == {"frt.get_rnnt_logprobs", "frt.get_rnnt_logprobs_smoothed"}


def test_the_readers_attribute_the_last_host_cycle(capsys):
    """watch() keeps the last profiled run with CPU activity, as the span
    readers see the harness's host cycle; cycle() attributes it once, with
    the steps of one cycle, and prints the split."""
    spans.watch()
    spans.watch()
    with profile(activities=[ProfilerActivity.CPU]):
        recipe_step()
    with profile(activities=[ProfilerActivity.CPU]):
        recipe_step()
        recipe_step()
    ctx = {"steps": 6, "cycles": 3}
    # no device here: every layer reads 0, the host time does not
    assert spans.layer_ms(ctx, "pruning") == 0.0 and spans.host_ms(ctx) > 0
    a = ctx["spans"]
    assert a["steps"] == 2 and "frt.do_rnnt_pruning" in a["seen"]
    assert capsys.readouterr().err.startswith("spans frt.")
    # read once: a later run does not change what this run's ctx holds
    with profile(activities=[ProfilerActivity.CPU]):
        recipe_step()
    assert spans.cycle(ctx) is a
    assert spans.cycle({"steps": 2, "cycles": 1})["steps"] == 2
    assert spans.cycle({"steps": 2, "cycles": 1}) is None


def test_without_spans_the_readers_read_nothing(monkeypatch):
    """A program without spans (the parent of this benchmark's span
    metrics), or a run without a host cycle: every reader returns None."""
    spans.watch()
    monkeypatch.setattr(partition, "_profiler_enabled", lambda: False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recipe_step()
    a = spans.attribute(prof.events(), 1)
    assert a["seen"] == [] and a["cycle_device_s"] == 0.0
    ctx = {"steps": 1, "cycles": 1}
    assert all(spans.layer_ms(ctx, k) is None for k in spans.ORDER)
    assert spans.host_ms(ctx) is None and ctx["spans"]["seen"] == []
    assert spans.layer_ms({"steps": 1, "cycles": 1}, "build") is None


def _event(name, device, start, end, parent=None, **kw):
    dt = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dt, cpu_parent=parent, sequence_nr=-1, thread=1,
                           time_range=SimpleNamespace(start=start, end=end,
                                                      elapsed_us=lambda: end - start), **kw)


def test_device_event_goes_to_its_launch():
    """A kernel goes to the operation around the runtime call that launched
    it, the call with the kernel's correlation id; a kernel without one is
    counted apart."""
    span = _event("frt.do_rnnt_pruning", False, 0, 100, id=1)
    op = _event("aten::index", False, 10, 50, span, id=2)
    call = _event("cudaLaunchKernel", False, 20, 25, op, id=900)
    caller = _event("aten::add", False, 200, 220, id=3)
    call2 = _event("cudaLaunchKernel", False, 205, 210, caller, id=901)
    k1 = _event("index_kernel", True, 60, 90, id=900)
    k2 = _event("add_kernel", True, 230, 240, id=901)
    lost = _event("lost_kernel", True, 250, 254, id=999)
    a = spans.attribute([span, op, call, caller, call2, k1, k2, lost], 2)
    assert a["device_s"]["pruning"] == pytest.approx(30e-6)
    assert a["device_s"]["caller"] == pytest.approx(14e-6)
    assert a["unknown_s"] == pytest.approx(4e-6)
    assert a["cycle_device_s"] == pytest.approx(44e-6)
    assert spans.layer_ms({"spans": a}, "pruning") == pytest.approx(15e-3)
    # the program's host time leaves out its runtime calls
    assert (a["host_s"], a["runtime_s"]) == pytest.approx((95e-6, 5e-6))
