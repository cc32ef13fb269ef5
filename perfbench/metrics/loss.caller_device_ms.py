"""Device milliseconds a step of the work under no span of the port: the
caller's own (the recipe's ``am_p + lm_p``, the sums of the losses and
their backward), and any device work whose launch was not found
(perfbench/spans.py)."""

from perfbench import spans

spans.watch()


def read(ctx):
    return spans.layer_ms(ctx, "caller")
