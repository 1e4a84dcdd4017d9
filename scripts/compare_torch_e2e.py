#!/usr/bin/env python3
"""Encode and decode MB/s of two checkouts of the repository, in turns on
one GPU.

    python3 scripts/compare_torch_e2e.py PARENT_ROOT [--rounds R]

PARENT_ROOT is another checkout (for example `git archive` of the parent
commit unpacked into a directory that .gitignore lists); the other side
is the checkout that holds this script. Each run is a fresh process in
one checkout's root that drives qvz_tpu_torch's public entry points on
the input of chip_smoke.py (1,000,000 x 100, seed 42, -f 0.5, MSE,
--shards 0, the debug WELL seed): the encode at -c 1 and -c 3 -T 4,
primed and unprimed, and decode(device="cuda") of each container, each
timed as the median of 3 after one warm-up, with the phase split
(seconds) of the last of the 3. Runs go parent, change, change, parent,
R times. Prints one JSON line a run, then the median and quartiles of
the MB/s and phase seconds of each side, each configuration, and the
change's ratio to the parent's median. The end-to-end numbers of one checkout alone come from
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CONFIGS = [(1, True), (1, False), (3, True), (3, False)]


def make_input(n: int, cols: int, seed: int):
    """chip_smoke.py's generator: a random start, +-2 steps, a drift
    down the read, clipped to Phred 2..41."""
    import numpy as np
    rng = np.random.default_rng(seed)
    start = rng.integers(28, 40, size=(n, 1))
    steps = rng.integers(-2, 3, size=(n, cols - 1)) \
        - (np.arange(cols - 1) // 40)
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 2,
                   41).astype(np.uint8)


def child() -> int:
    """One run in the current directory's checkout; prints its JSON."""
    sys.path.insert(0, os.getcwd())
    import torch
    from qvz_tpu_torch.constants import DISTORTION_MSE
    from qvz_tpu_torch.ops.distortion import make_matrix
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import decode as pdec
    from qvz_tpu_torch.pipeline import encode as penc

    if not torch.cuda.is_available():
        print("compare_torch_e2e: no CUDA device is visible",
              file=sys.stderr)
        return 1
    n, cols = 1_000_000, 100
    mb = n * (cols + 1) / 1e6
    data = make_input(n, cols, 42)
    dist = make_matrix(DISTORTION_MSE)
    out = {}
    for k, prime in CONFIGS:
        kw = dict(n_clusters=k, cluster_threshold=4.0, shards=0,
                  prime=prime, well_state=WellState.debug(), device="cuda")
        comp = penc.encode(data, dist, want_recon=False, **kw).compressed
        enc, dec = [], []
        for _ in range(3):
            t = time.perf_counter()
            st = penc.encode(data, dist, want_recon=False, **kw).stats
            enc.append(time.perf_counter() - t)
        pdec.decode(comp, device="cuda")
        dst = {}
        for _ in range(3):
            t = time.perf_counter()
            pdec.decode(comp, device="cuda", stats=dst)
            dec.append(time.perf_counter() - t)
        out[f"-c {k} prime={prime}"] = {
            "encode_mb_s": mb / statistics.median(enc),
            "decode_mb_s": mb / statistics.median(dec),
            **{f"encode {p}": v for p, v in st.phase_seconds.items()},
            **{f"decode {p}": v for p, v in dst["phase_seconds"].items()}}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child()
    if not args.parent:
        ap.error("PARENT_ROOT is required")
    change = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = {"parent": os.path.abspath(args.parent), "change": change}
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child"],
                cwd=roots[side], capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[side].append(res)
            print(f"{side} ({time.perf_counter() - t:.1f} s): "
                  f"{json.dumps(res)}", flush=True)
    for cfg in runs["change"][0]:
        for metric in runs["change"][0][cfg]:
            if not all(metric in r[cfg] for rs in runs.values()
                       for r in rs):
                continue
            med = {side: statistics.median(r[cfg][metric] for r in rs)
                   for side, rs in runs.items()}
            quart = {side: [round(q, 4) for q in statistics.quantiles(
                [r[cfg][metric] for r in rs], n=4)[::2]] if len(rs) > 1
                else [] for side, rs in runs.items()}
            ratio = (f"{med['change'] / med['parent']:.3f}"
                     if med["parent"] else "-")
            print(f"{cfg} {metric}: parent {med['parent']:.4f}, change "
                  f"{med['change']:.4f} (ratio {ratio}; quartiles parent "
                  f"{quart['parent']}, change {quart['change']}; runs parent "
                  f"{[round(r[cfg][metric], 4) for r in runs['parent']]}, "
                  f"change "
                  f"{[round(r[cfg][metric], 4) for r in runs['change']]})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
