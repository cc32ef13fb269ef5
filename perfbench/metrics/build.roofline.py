"""Percent of the build kernels' device time that the build work the
step needs bounds from below (perfbench/roofline.py, build_work)."""

from perfbench import readings


def read(ctx):
    return readings.roofline_share(ctx, "build")
