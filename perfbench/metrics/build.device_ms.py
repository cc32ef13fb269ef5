"""Device milliseconds a step of the work under the build spans
(``frt.get_rnnt_logprobs*``), forward and backward (perfbench/spans.py)."""

from perfbench import spans

spans.watch()


def read(ctx):
    return spans.layer_ms(ctx, "build")
