"""Frames a step of the pruned lattices that the program's kernels built:
B x T of each ``get_rnnt_logprobs_pruned`` forward on the kernel route, 0
where the plain version built them.  The program's own counter
(``fast_rnnt_tpu_torch.utils.profiling.counters``) over the traced window;
None for a program without it."""

from perfbench import counters

counters.watch()


def read(ctx):
    return counters.per_step(ctx, "pruned_lattice.kernel_frames")
