"""Percent of the traced window that the loss step's needed work bounds from
below: the larger of its bytes over the memory bandwidth and the lattice
products over the TF32 tensor-core peak (perfbench/roofline.py,
loss_step_work)."""

from perfbench import readings


def read(ctx):
    return readings.step_share(ctx, "step")
