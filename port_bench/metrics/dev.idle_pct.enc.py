"""The share of the traced window of encodes in which the card ran no
kernel, copy or set (1 - the union of their intervals over the window),
in %."""


def read(ctx):
    if ctx.op != "encode" or ctx.window_us is None:
        return None
    return 100.0 * (1.0 - ctx.busy_us / ctx.window_us)
