"""Set-up seconds: process start to the first timed step (host clock)."""


def read(ctx):
    return ctx["setup_s"]
