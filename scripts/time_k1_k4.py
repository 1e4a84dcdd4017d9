#!/usr/bin/env python3
"""K1's and K4's times on one GPU, taken several ways, in this checkout
and in another.

    python3 scripts/time_k1_k4.py [PARENT_ROOT]

PARENT_ROOT is another checkout (for example `git archive` of the parent
commit unpacked into a directory that .gitignore lists). Each run is a
fresh process in one checkout's root, through the entry points both
share (tables_to_torch, quantize_t_device, kmeans_step), on the input of
chip_smoke.py (1,000,000 x 100, seed 42, -f 0.5, MSE, the debug WELL
seed): K4, one step at K = 3 from seed_centroids, and K1 at -c 1 and at
-c 3 (the k-means ids). Each is timed four ways: the kernel's device
time (torch.profiler, the mean of 10 launches), one call in turns with
its plain PyTorch version (the method of chip_smoke.py, median of 5),
one call alone (median of 5) and 10 calls back to back (median of 3),
each a CUDA-event time a call. Then the encode's quantize phase as the encode
runs it: tables_to_torch and quantize_t_device, fenced, on the host
clock (median of 5). Runs go parent, change, change, parent where
PARENT_ROOT is given, else one run here. Prints the card's name and
power limit, one JSON line a run, then each time's median on each side
and the change's ratio to the parent. Without a card it exits 1.
chip_smoke.py checks the kernels; this script only times them.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def child() -> int:
    """One run in the current directory's checkout; prints its JSON."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_k1_k4: no CUDA device is visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from qvz_tpu_torch.constants import DISTORTION_MSE, MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import kmeans as tk
    from qvz_tpu_torch.ops import quantize as tq
    from qvz_tpu_torch.ops import stats as ts
    from qvz_tpu_torch.ops.distortion import make_matrix
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host
    from qvz_tpu_torch.spec.kmeans import seed_centroids

    dev = torch.device("cuda")
    out = {}

    def device_ms(fn, key: str, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # the mean a launch: the profiler may drop some of the events
        evs = [e for e in prof.key_averages() if key in e.key]
        total = sum((getattr(e, "device_time_total", None)
                     or e.cuda_time_total) for e in evs)
        launches = sum(e.count for e in evs)
        return total / 1e3 / launches if launches else float("nan")

    def report(tag, fn, plain, key):
        out[f"{tag} device"] = device_ms(fn, key)
        out[f"{tag} in turns"] = cs.in_turns(fn, plain, torch)[0]
        out[f"{tag} alone"] = statistics.median(
            cs.event_ms(fn, torch) for _ in range(5))
        out[f"{tag} 10 back to back"] = statistics.median(cs.event_ms(
            lambda: [fn() for _ in range(10)], torch) / 10 for _ in range(3))

    n, cols = 1_000_000, 100
    data = cs.make_input(n, cols, 42)
    data_t = torch.from_numpy(np.ascontiguousarray(data.T)).to(dev)
    seeds = torch.from_numpy(seed_centroids(data, 3).astype(np.int64)).to(dev)
    report("K4 K=3", lambda: tk.kmeans_step(data_t, seeds),
           lambda: tk.kmeans_step_reference(data_t, seeds), "kmeans_kernel")

    ids, _, _ = tk.kmeans_cluster(data, 3, 4.0, data_t=data_t)
    counts, states, _, _ = host.shard_plan(
        n, cols, port.device_lane_count(n), True, WellState.debug())
    draws_t = torch.from_numpy(host._shard_draws(states, counts, cols)).to(
        dev).t().contiguous()
    dist = make_matrix(DISTORTION_MSE)
    for k, cl in ((1, None), (3, ids)):
        c0, cond = ts.conditional_counts_t(data_t, cl, k)
        tables = rt.Design(c0.cpu().numpy(), cond.cpu().numpy(), MODE_RATIO,
                           0.5, dist).tables()
        tabs = tq.tables_to_torch(tables, dev)
        plain = {key: v.to(dev) if isinstance(v, torch.Tensor) else v
                 for key, v in tq.tables_to_torch(tables, "cpu").items()}
        report(f"K1 -c {k}",
               lambda: tq.quantize_t_device(tabs, data_t, draws_t, cl),
               lambda: tq.quantize_reference(plain, data_t, draws_t, cl),
               "quantize_kernel")
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tq.quantize_t_device(tq.tables_to_torch(tables, dev), data_t,
                                 draws_t, cl)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        out[f"quantize phase -c {k}"] = statistics.median(runs[1:])
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--child"]:
        return child()
    if len(sys.argv) > 2 or any(a.startswith("-") for a in sys.argv[1:]):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    change = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = {"change": change}
    order = ["change"]
    if len(sys.argv) == 2:
        roots["parent"] = os.path.abspath(sys.argv[1])
        order = ["parent", "change", "change", "parent"]
    sys.path.insert(0, change)
    from qvz_tpu_torch.roofline import smi
    print(smi("name,power.limit"), flush=True)
    runs = {side: [] for side in roots}
    for side in order:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"],
            cwd=roots[side], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[side].append(res)
        print(f"{side} ({time.perf_counter() - t:.1f} s): {json.dumps(res)}",
              flush=True)
    for key in runs["change"][0]:
        med = {side: statistics.median(r[key] for r in rs)
               for side, rs in runs.items()}
        line = f"{key}: change {med['change']:.4f} ms"
        if "parent" in med:
            line += (f", parent {med['parent']:.4f} ms (ratio "
                     f"{med['change'] / med['parent']:.3f})")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
