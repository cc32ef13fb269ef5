"""Milliseconds a loss step: the whole window over the steps it completed
(host clock, closed loop, the window ends on torch.cuda.synchronize())."""


def read(ctx):
    if "busy_s" in ctx:
        return None
    return 1e3 * ctx["window_s"] / ctx["steps"]
