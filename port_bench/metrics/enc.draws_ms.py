"""Milliseconds of the program's `draws` phase per encode, the mean over
the window's files."""


def read(ctx):
    return ctx.phase_ms("encode", "draws")
