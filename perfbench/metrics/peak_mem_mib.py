"""torch.cuda.max_memory_allocated() over the window, reset at its start."""


def read(ctx):
    return ctx["peak_bytes"] / 2**20
