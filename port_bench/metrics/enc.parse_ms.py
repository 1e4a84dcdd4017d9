"""Milliseconds of the program's `parse` phase per encode, the text's
parse into an (N, cols) matrix of reads in ``api.compress_bytes``; the
mean over the window's files, None where the program has no such
phase."""


def read(ctx):
    return ctx.phase_ms("encode", "parse")
