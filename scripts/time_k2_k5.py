#!/usr/bin/env python3
"""K2a's, K2b's and K5's times on one GPU at 1M x 100, and the device
decode's and encode's phases, in this checkout and in another.

    python3 scripts/time_k2_k5.py [PARENT_ROOT]

PARENT_ROOT is another checkout (for example `git archive` of the parent
commit unpacked into a directory that .gitignore lists). Each run is a
fresh process in one checkout's root, through the entry points both
share, on the input of chip_smoke.py (1,000,000 x 100, seed 42, -f 0.5,
MSE, -c 1, the device lane count, primed, the debug WELL seed): K1 on the
card gives mid and qs, the warmup shard the bank; K2a (``triples``) over
all columns, K2b (``chain``) over all columns from a fresh lane output,
and K5 (``decode_lanes_t``) over all columns of the lanes of the port's
host-engine container, each a CUDA-event time, median of 9 after a
warm-up. Then ``pipeline.decode.decode(device="cuda")`` of the port's
host-engine containers at -c 1 and -c 3 -T 4, primed and unprimed, and
``pipeline.encode.encode(device="cuda")`` at -c 3 -T 4 primed and
unprimed: each the median of 5 wall times after a warm-up, with the
median run's phases (``decode_<name>_<phase>``, ``encode_c3_<name>_
<phase>``). Where the checkout has them, K5p's and K2s's device times
on the -c 3 primed lanes (torch.profiler, the mean of 10 launches).
Runs go parent, change, change, parent where
PARENT_ROOT is given, else one run here. Prints the card's name and power
limit, one JSON line a run, then each time's median over the runs on
each side and the change's ratio to the parent. Without a card it exits
1. chip_smoke.py checks the kernels; this script only times them.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPS = 9


def child() -> int:
    """One run in the current directory's checkout; prints its JSON."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k2_k5: no CUDA device is visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from qvz_tpu_torch.constants import DISTORTION_MSE, MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.ops import quantize as tq
    from qvz_tpu_torch.ops.distortion import make_matrix
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import decode as pdec
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host

    n, cols = 1_000_000, 100
    data = cs.make_input(n, cols, 42)
    dist = make_matrix(DISTORTION_MSE)
    c0, cond = rt.stats_host(data, None, 1)
    tables = rt.Design(c0, cond, MODE_RATIO, 0.5, dist).tables()
    shards = port.device_lane_count(n)
    counts, states, offs, _ = host.shard_plan(n, cols, shards, True,
                                              WellState.debug())
    draws = host._shard_draws(states, counts, cols)
    data_t = torch.from_numpy(data).cuda().t().contiguous()
    draws_t = torch.from_numpy(draws).cuda().t().contiguous()
    mid, qs, _ = tq.quantize_t_device(tq.tables_to_torch(tables, "cuda"),
                                      data_t, draws_t, None)
    w_n = int(counts[0])
    md0, qs0, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data[:w_n].T), None, states[0])
    bank = rt.bank_from_stream(tables, md0, qs0, None, w_n)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, bank), "cuda")
    lanes, base = list(counts[1:]), int(offs[1])
    W, L = len(lanes), max(lanes)

    def median_ms(fn, before=None) -> float:
        if before is not None:
            before()
        fn()
        runs = []
        for _ in range(REPS):
            if before is not None:
                before()
            torch.cuda.synchronize()
            runs.append(cs.event_ms(fn, torch))
        return statistics.median(runs)

    out = {"root": os.getcwd()}

    def k2a():
        t = cd.triples(plan_t, mid, qs, lanes, base, 0, cols)
        out["trip"] = t[0] if isinstance(t, tuple) else t  # the parent's

    out["coder_triples"] = median_ms(k2a)
    trip = out.pop("trip")
    mw = -(-cols * L * cd.BITS_PER_STEP_BOUND // 32) + 2
    raw = {}

    def fresh():
        raw["r"] = cd.start_raw(W, "cuda", mw)

    out["coder_chain"] = median_ms(
        lambda: cd.chain(trip, cols, lanes, raw["r"]), fresh)
    del trip, raw, mid, qs, data_t, draws_t

    comp = host.encode(data, dist, well_state=WellState.debug(),
                       shards=shards, prime=True,
                       want_recon=False).compressed
    ln = pdec.prepare_lanes(comp, "cuda")
    rows = torch.zeros((ln.draws_t.shape[1], cols + 1), dtype=torch.uint8,
                       device="cuda")
    out["decoder"] = median_ms(lambda: dd.decode_lanes_t(
        ln.dplan_t, ln.pays, ln.draws_t, ln.cl, ln.lane_counts, 0,
        ln.starts, rows, 33))
    del ln, rows

    def wall(name, fn):
        """The median of 5 wall times after a warm-up into out[name], and
        that run's phases (fn's result) into out[name + "_" + phase]."""
        fn()
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn()
            runs.append((time.perf_counter() - t, res))
        out[name], ph = sorted(runs, key=lambda r: r[0])[2]
        for key, v in ph.items():
            out[f"{name}_{key}"] = v

    for k, prime in ((1, True), (1, False), (3, True), (3, False)):
        kw = dict(n_clusters=k, cluster_threshold=4.0,
                  well_state=WellState.debug(), shards=shards, prime=prime)
        comp = (comp if (k, prime) == (1, True) else
                host.encode(data, dist, want_recon=False, **kw).compressed)
        st: dict = {}
        tag = f"c{k}_{'primed' if prime else 'unprimed'}"
        wall(f"decode_{tag}", lambda: (
            pdec.decode(comp, device="cuda", stats=st),
            dict(st["phase_seconds"]))[1])
        if (k, prime) == (3, True) and hasattr(dd, "cluster_prologue"):
            device_times(out, comp, pdec, dd, cd, torch)
    for prime in (True, False):
        wall(f"encode_c3_{'primed' if prime else 'unprimed'}",
             lambda: port.encode(
                 data, dist, n_clusters=3, cluster_threshold=4.0,
                 well_state=WellState.debug(), shards=0, prime=prime,
                 want_recon=False, device="cuda").stats.phase_seconds)
    print(json.dumps(out), flush=True)
    return 0


def device_times(out, comp, pdec, dd, cd, torch) -> None:
    """K5p's and K2s's device times (ms) on a container's lanes: the mean
    of 10 launches back to back under torch.profiler (K2s over the ids K5p
    decodes, from the lanes' plan)."""
    from torch.profiler import ProfilerActivity, profile

    ln = pdec.prepare_lanes(comp, "cuda")

    def device_ms(fn, key):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if key in e.key]
        total = sum((getattr(e, "device_time_total", None)
                     or e.cuda_time_total) for e in evs)
        n = sum(e.count for e in evs)
        return total / 1e3 / n if n else float("nan")

    out["cluster_prologue_device"] = device_ms(
        lambda: dd.cluster_prologue(ln.dplan_t, ln.pays, ln.lane_counts),
        "cluster_prologue_kernel")
    out["coder_segment_device"] = device_ms(
        lambda: cd.segment_triples(ln.dplan_t, ln.cl, ln.lane_counts, 0),
        "segment_kernel")


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        return child()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    order = ([("parent", parent), ("change", here), ("change", here),
              ("parent", parent)] if parent else [("change", here)])
    runs = {"parent": [], "change": []}
    for side, root in order:
        r = subprocess.run([sys.executable, os.path.join(
            here, "scripts", "time_k2_k5.py"), "--child"], cwd=root,
            capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        res = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"{side}: {json.dumps(res)}", flush=True)
        runs[side].append(res)
    for k in runs["change"][0]:
        if k == "root":
            continue
        med = {s: statistics.median(r[k] for r in v)
               for s, v in runs.items() if v and k in v[0]}
        ratio = (f", change / parent {med['change'] / med['parent']:.4f}"
                 if "parent" in med else "")
        unit = "ms" if k in ("coder_triples", "coder_chain", "decoder") \
            or k.endswith("_device") else "s"
        print(f"{k}: " + ", ".join(f"{s} {m:.6f} {unit}"
                                   for s, m in med.items()) + ratio,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
