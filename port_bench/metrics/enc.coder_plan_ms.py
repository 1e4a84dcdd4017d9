"""Milliseconds of the program's `coder_plan` phase per encode, the lane
coder's plan on the host, its upload and its models at risk, inside
`device_code`; the mean over the window's files of either encode
operation, None where the program has no such phase."""


def read(ctx):
    if ctx.op in ("encode", "encode_binned"):
        return ctx.phase_ms(ctx.op, "coder_plan")
    return None
