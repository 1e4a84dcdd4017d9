"""The device's side of a traced window, from torch.profiler's events:
each kernel, copy and set on the card as (start, end, name) in
microseconds, the seconds in which any of them ran (the union of their
intervals, the arithmetic of scripts/profile_torch_encode.py), the
time by name, and the gaps in which the card had nothing to do."""

from __future__ import annotations

import collections

# short names of the program's kernels, for the breakdown
SHORT = (("hist_kernel", "K3 hist"), ("kmeans", "K4 kmeans"),
         ("quantize", "K1 quantize"), ("segment_kernel", "K2s segment"),
         ("triples_kernel", "K2a triples"), ("chain_kernel", "K2b chain"),
         ("Memcpy HtoD", "copy to card"), ("Memcpy DtoH", "copy to host"),
         ("Memcpy DtoD", "copy on card"), ("Memset", "memset"))


def short(name: str) -> str:
    for key, label in SHORT:
        if key in name:
            return label
    return name[:60]


def device_events(prof, lo: float, hi: float, skip=()) -> list:
    """The card's events of the profile that end inside [lo, hi] (us),
    sorted by start; names in `skip` (the host ranges the profiler also
    draws on the card's timeline) are left out."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in skip:
            a, b = e.time_range.start, e.time_range.end
            if b > lo and a < hi:
                out.append((max(a, lo), min(b, hi), e.name))
    out.sort()
    return out


def cpu_range(prof, name: str):
    """(start, end) us of the host range recorded under `name`."""
    from torch.autograd import DeviceType
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name == name:
            return e.time_range.start, e.time_range.end
    return None


def busy_us(events: list) -> float:
    """The union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for a, b, _ in events:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def by_name(events: list) -> collections.Counter:
    c: collections.Counter = collections.Counter()
    for a, b, name in events:
        c[short(name)] += b - a
    return c


def gaps(events: list, lo: float, hi: float) -> list:
    """(us, label) of every stretch of [lo, hi] with no event, labelled
    by the device work on either side of it."""
    out = []
    end, prev = lo, "window start"
    for a, b, name in events:
        if a > end:
            out.append((a - end, f"after {prev}, before {short(name)}"))
        if b > end:
            end, prev = b, short(name)
    if hi > end:
        out.append((hi - end, f"after {prev}, before window end"))
    return out
