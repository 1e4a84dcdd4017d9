"""Milliseconds of the program's `lanes` phase per encode, from the first
launch of the device coder (K2s, K2a, K2b) to the last lane's raw output
on the host, inside `device_code`; the mean over the window's files of
either encode operation, None where the program has no such phase."""


def read(ctx):
    if ctx.op in ("encode", "encode_binned"):
        return ctx.phase_ms(ctx.op, "lanes")
    return None
