#!/usr/bin/env python3
"""What the host does while the card idles, in a traced run of a
benchmark cell, on one GPU.

    python3 scripts/trace_encode_host.py --workload c3-encode-10m
        --seed N [--seconds 51] [--out build/host_gaps.json]

Runs the cell as ``port_bench/run.py --trace 1`` does (the same set-up,
window, per-layer metrics and check) and keeps the window's profile.
Reports the program's phase ranges there (``qvz.<phase>``,
``qvz_tpu_torch/utils/spans.py``): how many of them the profiler drew on
the card's timeline (none is right), the share of the card's idle time
under some range, the idle seconds under each innermost phase, the ten
longest idle stretches named by the phase behind each (with each phase's
seconds there), and every window file's phase seconds and counters
(``EncodeStats.counters``). Prints the run's result line and then the
report, each one JSON line, and writes both to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="build/host_gaps.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import hostspans, run, trace
    spec = run.load_cell(args.workload)
    os.environ["QVZ_TPU_WARMUP_LINES"] = str(int(spec["cfg"]["warmup_lines"]))
    import torch
    if not torch.cuda.is_available():
        print("trace_encode_host: no CUDA device is visible", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType

    from qvz_tpu_torch import api

    # the window's profile, as run_cell hands it to trace.cpu_range
    seen: dict = {}
    cpu_range = trace.cpu_range

    def keep(prof, name):
        seen["prof"] = prof
        return cpu_range(prof, name)

    # each traced file's phases and counters
    files: list = []
    compress = api.compress_bytes

    def counted(*a, **k):
        blob, st = compress(*a, **k)
        if torch.autograd._profiler_enabled():
            files.append(dict(phases=dict(st.phase_seconds),
                              counters=dict(st.counters)))
        return blob, st

    trace.cpu_range, api.compress_bytes = keep, counted
    result = run.run_cell(args.workload, args.seed, args.seconds, True)
    prof = seen["prof"]
    lo, hi = cpu_range(prof, run.WINDOW)
    events = trace.device_events(prof, lo, hi, skip=(run.WINDOW,))
    ranges = hostspans.host_ranges(prof, lo, hi)
    stretches = hostspans.idle(events, lo, hi)
    idle_us = sum(b - a for a, b, _ in stretches)
    by_phase = hostspans.idle_by_phase(stretches, ranges)
    report = dict(
        card=torch.cuda.get_device_name(0), torch=torch.__version__,
        window_s=(hi - lo) / 1e6, idle_s=idle_us / 1e6,
        program_ranges=len(ranges),
        program_ranges_on_card=sum(1 for e in prof.events()
                                   if e.name.startswith(hostspans.PREFIX)
                                   and e.device_type != DeviceType.CPU),
        idle_under_a_phase_pct=100.0 * hostspans.covered_us(
            stretches, ranges) / idle_us,
        idle_s_by_phase={k: v / 1e6 for k, v in by_phase.most_common()},
        gaps=[[text, us / 1e6, {k: v / 1e6 for k, v in parts.items()}]
              for us, text, parts in hostspans.named_gaps(stretches,
                                                          ranges)],
        files=files)
    lines = [json.dumps(result), json.dumps(report)]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
