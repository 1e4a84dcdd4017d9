"""Milliseconds of the program's `warmup_wait` phase per encode, the wait
for the warmup shard's host coder thread after the last lane is fetched,
inside `device_code`; the mean over the window's files, None where the
program has no such phase."""


def read(ctx):
    return ctx.phase_ms("encode", "warmup_wait")
