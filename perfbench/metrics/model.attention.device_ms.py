"""Device milliseconds a step under ``frt.model.attention``, forward and
backward: every block's projections, position scores, shift, softmax and
out-projection (perfbench/model_spans.py)."""

from perfbench import model_spans

model_spans.watch()


def read(ctx):
    return model_spans.span_ms(ctx, "frt.model.attention")
