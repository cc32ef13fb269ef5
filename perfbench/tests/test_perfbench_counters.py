"""The program-counter reader (``perfbench/counters.py``,
``metrics/recursion.strip_blocks.py``) on the CPU: the counter's growth
over the first profiled run after the reader loads, a step of it; None for
a program without the counter, or with no profiled run."""

from torch.profiler import ProfilerActivity, profile

from fast_rnnt_tpu_torch.ops.kernels import wavefront
from fast_rnnt_tpu_torch.utils import profiling
from perfbench import harness


def test_strip_blocks_reads_the_first_window_a_step(monkeypatch):
    monkeypatch.setitem(wavefront.BLOCKS, "sweep", wavefront.BLOCKS["sweep"])
    read = harness.metric_reader("recursion.strip_blocks")  # set-up: not counted
    wavefront.BLOCKS["sweep"] += 80
    with profile(activities=[ProfilerActivity.CPU]):  # the window: 4 steps
        for _ in range(4):
            wavefront.BLOCKS["sweep"] += 240
    with profile(activities=[ProfilerActivity.CPU]):  # the cycle that names the gaps
        wavefront.BLOCKS["sweep"] += 240
    assert read({"steps": 4, "cycles": 1}) == 240.0


def test_strip_blocks_is_none_without_a_window_or_the_counter(monkeypatch):
    read = harness.metric_reader("recursion.strip_blocks")
    assert read({"steps": 4, "cycles": 1}) is None
    monkeypatch.delattr(profiling, "counters")  # a program without it
    read = harness.metric_reader("recursion.strip_blocks")
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert read({"steps": 4, "cycles": 1}) is None


def test_reader_loads_again_without_wrapping_again():
    """A second run in one process wraps the profiler once: the span
    readers' mark on ``__exit__`` survives."""
    harness.metric_reader("recursion.device_ms")
    harness.metric_reader("recursion.strip_blocks")
    enter, exit_ = profile.__enter__, profile.__exit__
    harness.metric_reader("recursion.device_ms")
    harness.metric_reader("recursion.strip_blocks")
    assert (profile.__enter__, profile.__exit__) == (enter, exit_)
    assert getattr(exit_, "keeps_the_run", False)
