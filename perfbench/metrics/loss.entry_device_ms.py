"""Device milliseconds a step of the work under a span of the port in
none of the layers of perfbench/spans.py: a loss entry's own glue."""

from perfbench import spans

spans.watch()


def read(ctx):
    return spans.layer_ms(ctx, "entry")
