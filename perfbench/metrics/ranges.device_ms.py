"""Device milliseconds a step of the work under the ranges spans
(``frt.get_rnnt_prune_ranges``, ``frt.get_rnnt_prune_ranges_rows``), the
window search and its glue (perfbench/spans.py)."""

from perfbench import spans

spans.watch()


def read(ctx):
    return spans.layer_ms(ctx, "ranges")
