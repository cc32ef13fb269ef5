"""Percent of the recursion kernels' device time that the recursion work the
step needs bounds from below (perfbench/roofline.py, recursion_work)."""

from perfbench import readings


def read(ctx):
    return readings.roofline_share(ctx, "recursion")
