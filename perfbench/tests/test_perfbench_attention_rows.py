"""The attention row counter's reader
(``metrics/model.attention.kernel_rows.py``) on the CPU: the counter's
growth over the first profiled run after the reader loads, a step of it;
None for a program without the counter, or with no profiled run."""

from torch.profiler import ProfilerActivity, profile

from fast_rnnt_tpu_torch.ops.kernels import relpos_attention
from fast_rnnt_tpu_torch.utils import profiling
from perfbench import harness

NAME = "model.attention.kernel_rows"
ROWS = 45 * 8 * 434 * 12  # one batch of the largest bucket, 12 blocks


def test_kernel_rows_reads_the_first_window_a_step(monkeypatch):
    monkeypatch.setattr(relpos_attention, "ROWS", relpos_attention.ROWS)
    read = harness.metric_reader(NAME)  # set-up: not counted
    relpos_attention.ROWS += ROWS
    with profile(activities=[ProfilerActivity.CPU]):  # the window: 4 steps
        for _ in range(4):
            relpos_attention.ROWS += ROWS
    with profile(activities=[ProfilerActivity.CPU]):  # the cycle that names the gaps
        relpos_attention.ROWS += ROWS
    assert read({"steps": 4, "cycles": 1}) == float(ROWS)


def test_kernel_rows_reads_zero_where_the_plain_version_ran(monkeypatch):
    monkeypatch.setattr(relpos_attention, "ROWS", 0)
    read = harness.metric_reader(NAME)
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert read({"steps": 2, "cycles": 1}) == 0.0


def test_kernel_rows_is_none_without_a_window_or_the_counter(monkeypatch):
    read = harness.metric_reader(NAME)
    assert read({"steps": 4, "cycles": 1}) is None
    counters = profiling.counters
    monkeypatch.setattr(profiling, "counters",  # a program without it
                        lambda: {k: v for k, v in counters().items() if k != NAME})
    read = harness.metric_reader(NAME)
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert read({"steps": 4, "cycles": 1}) is None
