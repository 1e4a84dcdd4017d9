"""Milliseconds of the program's `container` phase per encode, the shard
states and the container's assembly inside `code`; the mean over the
window's files, None where the program has no such phase."""


def read(ctx):
    return ctx.phase_ms("encode", "container")
