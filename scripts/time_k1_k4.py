#!/usr/bin/env python3
"""K1's, K3's and K4's times on one GPU, taken several ways, in this
checkout and in another.

    python3 scripts/time_k1_k4.py [PARENT_ROOT]

PARENT_ROOT is another checkout (for example `git archive` of the parent
commit unpacked into a directory that .gitignore lists). Each run is a
fresh process in one checkout's root, through the entry points both
share (tables_to_torch, quantize_t_device, kmeans_step,
conditional_counts_t), on the input of chip_smoke.py (1,000,000 x 100,
seed 42, -f 0.5, MSE, the debug WELL seed): K4, one step at K = 3 from
seed_centroids; K3 at C = 1 and C = 3 (the k-means ids), on the input
and on its copy binned to a NovaSeq's four Phred values (2, 12, 23,
37), and at C = 150 on 200,000 x 20 (the ids of kmeans_cluster on the
card); K1 at -c 1 and at -c 3. Each is timed six ways: the kernel's
device time (torch.profiler, the mean of 10 launches back to back, and
of 5 launches each right after the plain PyTorch version); one call in
turns with the plain version (the method of chip_smoke.py, median of
5), one call alone (median of 5) and 10 calls back to back (median of
3), each a CUDA-event time a call; and the host clock from one call to
its return right after the plain version (median of 5); for K3 also
that host clock split into the wrapper's steps (the ctypes call of
qvz_hist with the CUDA launch inside, the output's torch.zeros, the
argument check, the planner's lookup where the checkout has one, the
stream lookup) and the rest, the wrapper's own Python (medians of 20,
each right after the plain version).
A profiler that
reports no launch reads nan, and the medians skip it. Then the encode's
quantize phase as the encode
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
from math import nan


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

    def device_ms(fn, key: str, reps: int = 10, before=None) -> float:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        # the mean a launch: the profiler may drop some of the events
        evs = [e for e in prof.key_averages() if key in e.key]
        total = sum((getattr(e, "device_time_total", None)
                     or e.cuda_time_total) for e in evs)
        launches = sum(e.count for e in evs)
        return total / 1e3 / launches if launches else float("nan")

    def host_ms(fn, plain, runs: int = 5) -> float:
        """The host clock from the call to its return, each call right
        after the plain version and a synchronise."""
        runs_ms = []
        for _ in range(runs):
            plain()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            runs_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(runs_ms)

    def host_split(fn, plain, runs: int = 20) -> dict:
        """host_ms split into the steps of the wrapper that either side
        has (each timed by wrapping it for these calls only): the ctypes
        launch of qvz_hist, torch.zeros, _check, card_hist_shape and
        torch.cuda.current_stream; "rest" is the wrapper's own Python."""
        from qvz_tpu_torch import _build
        steps = [(part, owner, attr) for part, owner, attr in (
            ("launch", _build.load(), "qvz_hist"),
            ("torch.zeros", torch, "zeros"),
            ("check", ts, "_check"),
            ("planner", ts, "card_hist_shape"),
            ("stream", torch.cuda, "current_stream"))
            if hasattr(owner, attr)]
        spent = dict.fromkeys((part for part, _, _ in steps), 0.0)

        def timed(part, f):
            def call(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return f(*args, **kwargs)
                finally:
                    spent[part] += time.perf_counter() - t
            return call

        saved = [getattr(owner, attr) for _, owner, attr in steps]
        for (part, owner, attr), f in zip(steps, saved):
            setattr(owner, attr, timed(part, f))
        rows = []
        try:
            for _ in range(runs):
                plain()
                torch.cuda.synchronize()
                spent.update(dict.fromkeys(spent, 0.0))
                t = time.perf_counter()
                fn()
                total = time.perf_counter() - t
                torch.cuda.synchronize()
                rows.append(dict(spent, call=total,
                                 rest=total - sum(spent.values())))
        finally:
            for (_, owner, attr), f in zip(steps, saved):
                setattr(owner, attr, f)
        return {part: statistics.median(r[part] for r in rows) * 1e3
                for part in rows[0]}

    def report(tag, fn, plain, key):
        out[f"{tag} device"] = device_ms(fn, key)
        out[f"{tag} device in turns"] = device_ms(fn, key, 5, plain)
        out[f"{tag} in turns"] = cs.in_turns(fn, plain, torch)[0]
        out[f"{tag} host in turns"] = host_ms(fn, plain)
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
    nova = np.array([2, 12, 23, 37], np.int16)
    binned = nova[np.abs(data[..., None].astype(np.int16) - nova).argmin(-1)]
    binned_t = torch.from_numpy(np.ascontiguousarray(
        binned.T.astype(np.uint8))).to(dev)
    data2 = cs.make_input(200_000, 20, 42)
    data2_t = torch.from_numpy(np.ascontiguousarray(data2.T)).to(dev)
    ids2, _, _ = tk.kmeans_cluster(data2, 150, 4.0, data_t=data2_t)
    for tag, d_t, cl, k in (
            ("K3 C=1", data_t, None, 1), ("K3 C=3", data_t, ids, 3),
            ("K3 binned C=1", binned_t, None, 1),
            ("K3 binned C=3", binned_t, ids, 3),
            ("K3 C=150 200000 x 20", data2_t, ids2, 150)):
        fns = (lambda: ts.conditional_counts_t(d_t, cl, k),
               lambda: ts.conditional_counts_reference(d_t, cl, k))
        report(tag, *fns, "hist_kernel")
        for part, ms in host_split(*fns).items():
            out[f"{tag} host split: {part}"] = ms
    del binned_t, data2_t
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
        # the median of the runs that read a time (the profiler may
        # report no launch of a kernel)
        med = {side: statistics.median([r.get(key, nan) for r in rs
                                        if r.get(key, nan) == r.get(
                                            key, nan)] or [nan])
               for side, rs in runs.items()}
        line = f"{key}: change {med['change']:.4f} ms"
        if "parent" in med:
            line += (f", parent {med['parent']:.4f} ms (ratio "
                     f"{med['change'] / med['parent']:.3f})")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
