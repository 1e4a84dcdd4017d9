"""Milliseconds of the program's `device_code` phase per encode, the mean over
the window's files."""


def read(ctx):
    return ctx.phase_ms("encode", "device_code")
