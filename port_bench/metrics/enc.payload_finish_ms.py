"""Milliseconds of the program's `payload_finish` phase per encode, the
lanes' payloads assembled on the host from their raw output, inside
`device_code`; the mean over the window's files of either encode
operation, None where the program has no such phase."""


def read(ctx):
    if ctx.op in ("encode", "encode_binned"):
        return ctx.phase_ms(ctx.op, "payload_finish")
    return None
