"""Blocks a step of the recursion's diagonal-sweep launches: B x strips a
launch where an utterance's 128-row strips are swept at once, B where one
block sweeps them one after another.  The program's own counter
(``fast_rnnt_tpu_torch.utils.profiling.counters``) over the traced window;
None for a program without it."""

from perfbench import counters

counters.watch()


def read(ctx):
    return counters.per_step(ctx, "recursion.strip_blocks")
