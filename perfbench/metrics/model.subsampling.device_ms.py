"""Device milliseconds a step under ``frt.model.subsampling``, forward and
backward: the front end's two convs, the Dense after them and the xscale
(perfbench/model_spans.py)."""

from perfbench import model_spans

model_spans.watch()


def read(ctx):
    return model_spans.span_ms(ctx, "frt.model.subsampling")
