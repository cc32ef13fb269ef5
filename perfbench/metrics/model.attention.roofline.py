"""Percent of the device time under ``frt.model.attention`` that the
attention's needed work bounds from below: its products (in-projection,
position projection, (q+u) k^T, (q+v) p^T, probabilities times v,
out-projection; forward and backward) over the bf16 tensor-core peak, or
its bytes over the memory bandwidth (perfbench/model_work.py)."""

from perfbench import model_spans

model_spans.watch()


def read(ctx):
    return model_spans.roofline_share(ctx, "attention", "frt.model.attention")
