#!/usr/bin/env python3
"""K2a's, K2b's and K5's times on one GPU at 1M x 100, in this checkout
and in another.

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
warm-up. Runs go parent, change, change, parent where PARENT_ROOT is
given, else one run here. Prints the card's name and power limit, one
JSON line a run, then each kernel's median over the runs on each side
and the change's ratio to the parent. Without a card it exits 1.
chip_smoke.py checks the kernels; this script only times them.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

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
    print(json.dumps(out), flush=True)
    return 0


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
    for k in ("coder_triples", "coder_chain", "decoder"):
        med = {s: statistics.median(r[k] for r in v)
               for s, v in runs.items() if v}
        ratio = (f", change / parent {med['change'] / med['parent']:.4f}"
                 if "parent" in med else "")
        print(f"{k}: " + ", ".join(f"{s} {m:.4f} ms" for s, m in med.items())
              + ratio, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
