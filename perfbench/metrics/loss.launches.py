"""Kernel launches a step, counted from the profiler's device kernels."""

from perfbench import readings


def read(ctx):
    return readings.launches(ctx)
