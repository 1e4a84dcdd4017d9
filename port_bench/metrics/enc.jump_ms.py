"""Milliseconds of the program's `jump` phase per encode, the GF(2)
jump-ahead of every shard's WELL start state on one host thread
(``shard_plan``) inside `draws`; the mean over the window's files, None
where the program has no such phase."""


def read(ctx):
    return ctx.phase_ms("encode", "jump")
