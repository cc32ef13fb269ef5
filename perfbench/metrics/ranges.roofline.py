"""Percent of the ranges kernels' device time that the ranges work the
step needs bounds from below (perfbench/roofline.py, ranges_work)."""

from perfbench import readings


def read(ctx):
    return readings.roofline_share(ctx, "ranges")
