"""Device milliseconds a step of the work under
``frt.get_rnnt_logprobs_pruned``, forward and backward: the pruned logits'
normaliser, their gathers and the windows placed on the full lattice
(perfbench/spans.py)."""

from perfbench import spans

spans.watch()


def read(ctx):
    return spans.layer_ms(ctx, "pruned_lattice")
