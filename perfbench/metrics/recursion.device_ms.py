"""Device milliseconds a step of the work under the recursion spans
(``frt.mutual_information_rows``, ``frt.mutual_information_recursion``),
forward and backward (perfbench/spans.py)."""

from perfbench import spans

spans.watch()


def read(ctx):
    return spans.layer_ms(ctx, "recursion")
