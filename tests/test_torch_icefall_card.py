"""icefall's pruned-transducer conformer (the port's ``recipe="icefall"``)
on the card, at the published widths of
``perfbench/configs/icefall-conformer-l12-d512.json``.  They need an
NVIDIA GPU and skip without one; run them there with

    python -m pytest --noconftest tests/test_torch_icefall_card.py -m cuda

  * the training step on one duration bucket of the benchmark's traffic
    (the 16.6 s bucket: the longest utterances), held against the plain
    reference by the benchmark cell's own check and limits;
  * one profiled step sees every span of the model's parts, each with
    device time.
"""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import model_spans
from perfbench.drivers import model_step

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
SPANS = {f"frt.model.{p}" for p in ("subsampling", "attention", "conv_module", "feed_forward",
                                    "predictor", "joiner", "optimizer")}


@pytest.fixture(scope="module")
def cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's kernels")
    read = lambda sub, name: json.loads((ROOT / "perfbench" / sub / f"{name}.json").read_text())
    cfg = read("configs", "icefall-conformer-l12-d512")
    traffic = {**read("traffic", "train-librispeech"), "centres": [16.6]}
    limits = read("limits", "conformer.train-librispeech")
    obj = model_step.setup(cfg, traffic, 3_000_000_022, "cuda")
    yield obj, limits
    obj.release()


def test_step_at_published_widths_matches_reference(cell):
    """The judged step after six more, so that Adam's moments carry a
    history as in the cell's window."""
    obj, limits = cell
    assert obj.n == 1
    for _ in range(7):
        obj.step(0)
    torch.cuda.synchronize()
    obj.release()
    checks = obj.check(limits)
    assert all(v <= lim for v, lim in checks.values()), checks


def test_one_profiled_step_sees_every_model_span(cell):
    obj, _ = cell
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        obj.step(0)
        torch.cuda.synchronize()
    a = model_spans.attribute(prof.events(), 1)
    assert SPANS <= set(a["seen"])
    assert all(a["device_s"].get(s, 0.0) > 0.0 for s in SPANS), a["device_s"]
