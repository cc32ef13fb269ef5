"""The pruned-lattice frame counter's reader
(``metrics/pruned_lattice.kernel_frames.py``) on the CPU: the counter's
growth over the first profiled run after the reader loads, a step of it;
None for a program without the counter, or with no profiled run."""

from torch.profiler import ProfilerActivity, profile

from fast_rnnt_tpu_torch.ops.kernels import pruned
from fast_rnnt_tpu_torch.utils import profiling
from perfbench import harness

NAME = "pruned_lattice.kernel_frames"


def test_kernel_frames_reads_the_first_window_a_step(monkeypatch):
    monkeypatch.setattr(pruned, "FRAMES", pruned.FRAMES)
    read = harness.metric_reader(NAME)  # set-up: not counted
    pruned.FRAMES += 8 * 12000
    with profile(activities=[ProfilerActivity.CPU]):  # the window: 3 steps
        for _ in range(3):
            pruned.FRAMES += 8 * 12000
    with profile(activities=[ProfilerActivity.CPU]):  # the cycle that names the gaps
        pruned.FRAMES += 8 * 12000
    assert read({"steps": 3, "cycles": 1}) == 96000.0


def test_kernel_frames_reads_zero_where_the_plain_version_ran(monkeypatch):
    monkeypatch.setattr(pruned, "FRAMES", 0)
    read = harness.metric_reader(NAME)
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert read({"steps": 2, "cycles": 1}) == 0.0


def test_kernel_frames_is_none_without_a_window_or_the_counter(monkeypatch):
    read = harness.metric_reader(NAME)
    assert read({"steps": 4, "cycles": 1}) is None
    counters = profiling.counters
    monkeypatch.setattr(profiling, "counters",  # a program without it
                        lambda: {k: v for k, v in counters().items() if k != NAME})
    read = harness.metric_reader(NAME)
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert read({"steps": 4, "cycles": 1}) is None
