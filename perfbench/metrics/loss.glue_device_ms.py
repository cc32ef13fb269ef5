"""Device milliseconds a loss step of every kernel that is not one of the
port's own CUDA kernels: the plain-torch glue and autograd."""

from perfbench import readings


def read(ctx):
    if not ctx.get("kernels"):
        return None
    return 1e3 * readings.kernel_seconds(ctx, "*.cu*", own=False) / ctx["steps"]
