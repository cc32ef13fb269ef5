"""Device milliseconds a step of the work under ``frt.do_rnnt_pruning``,
forward and backward: the gather of lm's window rows and its scatter-add
(perfbench/spans.py)."""

from perfbench import spans

spans.watch()


def read(ctx):
    return spans.layer_ms(ctx, "pruning")
