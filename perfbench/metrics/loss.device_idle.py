"""Percent of the traced window in which no operation ran on the device."""

from perfbench import readings


def read(ctx):
    return readings.idle_share(ctx)
