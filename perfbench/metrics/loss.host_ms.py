"""Host milliseconds a step in the port: the outermost spans' durations
and the backward nodes that belong to them, less the CUDA runtime calls
inside them (where the device is behind, mostly a wait for room in the
launch queue); read under the profiler, so an upper bound
(perfbench/spans.py)."""

from perfbench import spans

spans.watch()


def read(ctx):
    return spans.host_ms(ctx)
