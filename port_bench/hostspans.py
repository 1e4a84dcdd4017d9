"""The host's side of a traced window: the program's phase ranges
(``qvz.<phase>``, ``qvz_tpu_torch/utils/spans.py``) from torch.profiler's
events, and each stretch in which the card was idle named by the host
phase under it.

The program opens its ranges as operator ranges, which the profiler does
not draw on the card's timeline, so ``trace.device_events`` does not see
them. Times are microseconds on the profiler's clock, as in ``trace``.
"""

from __future__ import annotations

import collections

PREFIX = "qvz."


def host_ranges(prof, lo: float, hi: float) -> list:
    """(start, end, phase, depth) of the program's ranges on the host
    that overlap [lo, hi], clipped to it and sorted by start; depth 0 is
    outermost."""
    from torch.autograd import DeviceType
    spans = sorted(
        (e.time_range.start, -e.time_range.end, e.name[len(PREFIX):])
        for e in prof.events()
        if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX)
        and e.time_range.end > lo and e.time_range.start < hi)
    return nest([(a, -b, name) for a, b, name in spans], lo, hi)


def nest(spans: list, lo: float, hi: float) -> list:
    """(start, end, phase, depth) of (start, end, phase) ranges sorted by
    start, outer before inner at one start; clipped to [lo, hi]."""
    out, open_ends = [], []
    for a, b, name in spans:
        while open_ends and open_ends[-1] <= a:
            open_ends.pop()
        out.append((max(a, lo), min(b, hi), name, len(open_ends)))
        open_ends.append(b)
    return out


def idle(events: list, lo: float, hi: float) -> list:
    """(start, end, label) of every stretch of [lo, hi] in which none of
    the card's events (start, end, name) ran, labelled as
    ``trace.gaps`` labels them."""
    from port_bench.trace import short
    out, end, prev = [], lo, "window start"
    for a, b, name in events:
        if a > end:
            out.append((end, a, f"after {prev}, before {short(name)}"))
        if b > end:
            end, prev = b, short(name)
    if hi > end:
        out.append((end, hi, f"after {prev}, before window end"))
    return out


def _overlap(a: float, b: float, c: float, d: float) -> float:
    return max(0.0, min(b, d) - max(a, c))


def label(a: float, b: float, ranges: list) -> str:
    """The phase behind the stretch [a, b]: the innermost range that
    covers more than half of it, else the range that covers most of it,
    else "none"."""
    best, best_key = "none", (0.0, 0)
    for c, d, name, depth in ranges:
        if c >= b:
            break
        ov = _overlap(a, b, c, d)
        if ov <= 0.0:
            continue
        key = (2 * ov > b - a, depth if 2 * ov > b - a else ov)
        if key > best_key:
            best, best_key = name, key
    return best


def self_us(a: float, b: float, ranges: list) -> collections.Counter:
    """The microseconds of [a, b] under each phase, each instant given
    to the innermost range that covers it ("none" where none does)."""
    cuts = sorted({a, b} | {t for c, d, _, _ in ranges for t in (c, d)
                            if a < t < b})
    out: collections.Counter = collections.Counter()
    for x, y in zip(cuts, cuts[1:]):
        inner = [(depth, name) for c, d, name, depth in ranges
                 if c <= x and d >= y]
        out[max(inner)[1] if inner else "none"] += y - x
    return out


def idle_by_phase(stretches: list, ranges: list) -> collections.Counter:
    """``self_us`` summed over the (start, end, ...) stretches."""
    out: collections.Counter = collections.Counter()
    for s in stretches:
        a, b = s[0], s[1]
        out.update(self_us(a, b, [r for r in ranges
                                  if r[0] < b and r[1] > a]))
    return out


def covered_us(stretches: list, ranges: list) -> float:
    """The part of the (start, end, ...) stretches that lies under some
    range."""
    merged: list = []
    for c, d, _, _ in sorted(ranges):
        if merged and c <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], d)
        else:
            merged.append([c, d])
    return sum(_overlap(s[0], s[1], c, d) for s in stretches
               for c, d in merged)


def named_gaps(stretches: list, ranges: list, top: int = 10) -> list:
    """The `top` longest idle stretches as (us, their label with
    "; host: <phase>" added, the us of each phase under them), longest
    first."""
    longest = sorted(stretches, key=lambda s: s[0] - s[1])[:top]
    return [(b - a, f"{text}; host: {label(a, b, ranges)}",
             dict(self_us(a, b, ranges).most_common()))
            for a, b, text in longest]
