"""Device milliseconds a step under ``frt.model.optimizer``: Adam's step
over every parameter (perfbench/model_spans.py)."""

from perfbench import model_spans

model_spans.watch()


def read(ctx):
    return model_spans.span_ms(ctx, "frt.model.optimizer")
