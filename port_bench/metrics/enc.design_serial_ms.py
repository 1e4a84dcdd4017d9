"""Milliseconds of the program's `design_serial` phase per encode, the
design's steady-clock time outside its threaded Lloyd-Max context
sweeps, summed over the clusters (``rt.Design.stats``), inside `design`;
the mean over the window's files, None where the program has no such
phase."""


def read(ctx):
    return ctx.phase_ms("encode", "design_serial")
