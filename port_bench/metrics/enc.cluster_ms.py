"""Milliseconds of the program's `cluster` phase per encode, the mean over
the window's files."""


def read(ctx):
    return ctx.phase_ms("encode", "cluster")
