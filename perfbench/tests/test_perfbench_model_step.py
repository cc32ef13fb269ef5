"""The training-step cell's own pieces on the CPU: the work it counts, its
batches, its check against the plain reference (sound, the control and
each fault, at the configuration's CPU sizes), and the readers of the
model's spans on a program without them."""

import contextlib
import importlib.util
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness, model_spans, model_work
from perfbench.drivers import model_step
from perfbench.tests._layout import copy_layout

CELL = "conformer.train-librispeech"
CFG = harness.load_json(harness.ROOT / "perfbench" / "configs" / "icefall-conformer-l12-d512.json")
TRAFFIC = harness.load_json(harness.ROOT / "perfbench" / "traffic" / "train-librispeech.json")
READERS = ("model.attention.device_ms", "model.attention.roofline", "model.subsampling.device_ms",
           "model.optimizer.device_ms")


def test_forward_ops_by_hand():
    """One utterance of 23 input frames (T1 11, T 5), 2 symbols, at widths
    small enough to count by hand."""
    cfg = {"d_model": 4, "subsampling_channels": 2, "vocab_size": 3, "num_layers": 1,
           "ff_dim": 8, "conv_kernel": 3, "decoder_dim": 4, "context_size": 2, "feature_dim": 9,
           "num_heads": 2}
    ops = model_work.forward_ops(cfg, [23], [2], 5)
    # f1 = 4, f2 = 1: conv1 2*9*2*11*4, conv2 2*9*2*2*5*1, Dense 2*2*1*4*5
    assert ops["subsampling"] == 1584 + 360 + 80
    # in 2*4*12*5 + qk 2*25*4 + pos 2*5*9*4 + pv 2*25*4 + out 2*16*5, and the
    # position projection 2*9*16
    assert ops["attention"] == 480 + 200 + 360 + 200 + 160 + 288
    assert ops["conv_module"] == 2 * 4 * 8 * 5 + 2 * 3 * 4 * 5 + 2 * 16 * 5
    assert ops["feed_forward"] == 2 * (2 * 4 * 8 * 5 + 2 * 8 * 4 * 5)
    assert ops["encoder_out"] == 2 * 4 * 3 * 5
    assert ops["predictor"] == 3 * (2 * 2 * 4 + 2 * 4 * 3)
    assert ops["joiner"] == 2 * 3 * 3 * 5 * 5
    work = model_work.step_work(cfg, [([23], [2])], 5, params=100)
    assert work["model"][0] == 3 * sum(ops.values())
    assert work["model"][1] == 4 * 9 * 23 + 40 * 100
    assert work["attention"][0] == 3 * ops["attention"]
    weights = 3 * 16 + 12 + 16 + 16 + 4 + 8
    assert work["attention"][1] == 2 * (5 * 4 * 6 + 9 * 4 * 4 + weights * 4)


def test_published_step_is_about_fifteen_teraflop():
    """The cell's batches: B 93, 67, 55, 44 from the traffic's buckets, and
    ~15 TFLOP a step (~270 MFLOP a forward encoder frame)."""
    sizes = model_step.durations(TRAFFIC)
    assert [len(d) for d in sizes] == [93, 67, 55, 44]
    assert all(d.sum() <= 750.0 for d in sizes)
    batches = [((d * 100).round().astype(int).tolist(), (d * 4.3).round().astype(int).tolist())
               for d in sizes]
    ops = model_work.step_work(CFG, batches, 5, CFG["params"])["model"][0] / 4
    frames = sum(model_work.frames(t)[1] for t_in, _ in batches for t in t_in) / 4
    assert 1.4e13 < ops < 1.7e13 and 2.5e8 < ops / 3 / frames < 3.0e8


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return copy_layout(tmp_path_factory.mktemp("layout"))


# the limit that each plant fails
CAUGHT_BY = {"control": "pruned_rel", "half_batch": "pruned_rel", "altered": "pruned_rel",
             "lm_scale": "simple_rel"}


@pytest.mark.parametrize("plant", [None, "control", *model_step.FAULTS])
def test_check_holds_the_step(layout, plant):
    """At the CPU sizes: a sound step is correct; the control (am, lm and
    the joiner's logits in bfloat16) and each fault are not: a wrong stage-1
    smoothing by the simple loss's limit, the others by the pruned loss's."""
    kw = {} if plant is None else {"control": True} if plant == "control" else {"fault": plant}
    result, checks, _ = harness.run(layout, CELL, 2**31 + 5, 0.05, False, "cpu",
                                    time.perf_counter(), **kw)
    assert result["correct"] == (plant is None), checks
    if plant is not None:
        value, limit = checks[CAUGHT_BY[plant]]
        assert value > limit, checks


def test_check_leaves_out_the_rounding_gradients():
    """At the CPU sizes the tensors whose reference gradient's norm is under
    HELD_SHARE of the largest in their block are the conv modules'
    depthwise biases (BatchNorm removes each channel's mean right after
    them) and some of the position biases u, v; the rest are held."""
    obj = model_step.setup(CFG, TRAFFIC, 11, "cpu")
    for j in range(obj.n):
        obj.step(j)
    obj.release()
    obj.check({})
    leaves, readings = obj.detail["leaves"], obj.detail["readings"]
    out = {n for n, v in leaves.items() if not v["held"]}
    assert {n for n in leaves if n.endswith(".conv.dw.bias")} <= out
    assert all(n.endswith((".conv.dw.bias", ".pos_bias_u", ".pos_bias_v")) for n in out), out
    assert readings["unheld"] == len(out)
    assert readings["unheld_ref_grad_share"] < model_step.HELD_SHARE
    assert model_step.group("encoder.blocks.3.attn.in_proj.weight") == "encoder.blocks.3"
    assert model_step.group("joiner.out.bias") == "joiner.out"


def _reader(name):
    path = harness.ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"t_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("spans", [True, False], ids=["with-spans", "without-spans"])
def test_readers_of_the_model_spans(spans, monkeypatch):
    """On the CPU each span reads 0 device ms and the roofline nothing; on
    a program without the spans (the parent of this cell) every reader
    reads None, as it does where no cycle was profiled."""
    from fast_rnnt_tpu_torch.models import training, transducer

    if not spans:
        for mod in (training, transducer):
            monkeypatch.setattr(mod, "annotate", lambda name: contextlib.nullcontext())
    readers = {n: _reader(n) for n in READERS}
    obj = model_step.setup(CFG, TRAFFIC, 7, "cpu")  # the CPU sizes
    with profile(activities=[ProfilerActivity.CPU]):
        for j in range(obj.n):
            obj.step(j)
    obj.release()
    ctx = {"steps": obj.n, "cycles": 1, "work": obj.work()}
    got = {n: r(ctx) for n, r in readers.items()}
    if spans:
        assert got == {"model.attention.device_ms": 0.0, "model.attention.roofline": None,
                       "model.subsampling.device_ms": 0.0, "model.optimizer.device_ms": 0.0}
        assert {"frt.model.attention", "frt.model.optimizer"} <= set(ctx["model_spans"]["seen"])
    else:
        assert set(got.values()) == {None}
    assert all(r({"steps": 1, "cycles": 1, "work": {}}) is None for r in readers.values())


def test_mfu_reads_the_window():
    read = _reader("model.mfu")
    work = {"model": (989e12 * 0.5, 0.0, 989e12)}
    assert read({"work": work, "cycles": 2, "window_s": 4.0}) == pytest.approx(25.0)
    assert read({"work": {}, "cycles": 2, "window_s": 4.0}) is None


def test_benchmark_entries():
    """The cell on one chip, its configuration as published, and the five
    new metrics in its list."""
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in spec["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["config"] == "icefall-conformer-l12-d512"
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    assert entry["reduced"] == [] and entry["source"] == CFG["source"]
    layer = [m["name"] for m in spec["per_layer"] if CELL in m["workloads"]]
    assert set(layer) >= {"model.mfu", *READERS}
