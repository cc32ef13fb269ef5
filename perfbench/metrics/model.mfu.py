"""Percent of the traced window that the training step's model work bounds
from below: its products (3 x the forward's, counted from the configuration
and each utterance's lengths) over the bf16 tensor-core peak, or its bytes
over the memory bandwidth, whichever is larger (perfbench/model_work.py)."""

from perfbench import readings


def read(ctx):
    return readings.step_share(ctx, "model")
