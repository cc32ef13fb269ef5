"""Query rows a step of the relative-position attention that the program's
kernels computed: B x H x T of each ``RelPositionMultiHeadAttention``
forward on the kernel route, 0 where the plain version ran.  The program's
own counter (``fast_rnnt_tpu_torch.utils.profiling.counters``) over the
traced window; None for a program without it."""

from perfbench import counters

counters.watch()


def read(ctx):
    return counters.per_step(ctx, "model.attention.kernel_rows")
