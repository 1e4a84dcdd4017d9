"""The device coder's share of its roofline in a window of either encode
operation: the least time of the window's encodes
(``work.coder_least_s``) over the device time of the kernels K2s, K2a
and K2b, summed by layer, in % (``kern.coder_roofline``'s reading, which
reads only the operation "encode")."""

from port_bench import work


def read(ctx):
    if ctx.op not in ("encode", "encode_binned"):
        return None
    busy = ctx.kernel_s(work.CODER_KERNELS)
    if not busy:
        return None
    least = sum(work.coder_least_s(f["lines"], f["columns"],
                                   f["payload_bytes"]) for f in ctx.work)
    return 100.0 * least / busy
