#!/usr/bin/env python3
"""The control of a cell's `correct`: the plain reference put in the
program's place, with its codebook design in float32, the precision
below the float64 that the configuration states, compared with the
float64 reference exactly as a run compares the program's outputs (the
same lanes drawn from the seed).

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the file of the pool that a run with that seed
checks, at the cell's own size, and prints one JSON line: the numbers
compared and their limits. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control(workload: str, seed: int) -> dict:
    """The compared numbers of the control for the file that a run with
    `seed` checks (made on the card, as the run makes it)."""
    import numpy as np

    from port_bench import inputs, run
    spec = run.load_cell(workload)
    cfg, traffic = spec["cfg"], spec["traffic"]
    op = run.operation(traffic["op"])
    pool = int(traffic["pool"])
    sample = int(np.random.default_rng(seed).integers(pool))
    text = inputs.make_pool(seed, pool, int(traffic["reads"]),
                            int(cfg["columns"]), cfg["generator"],
                            "cuda")[sample]
    wseed = inputs.well_seed(seed)
    workers = os.cpu_count()
    t = time.perf_counter()
    want = op.expected(text, cfg, wseed, seed, workers=workers)
    low = op.expected(text, cfg, wseed, seed, dtype=np.float32,
                      workers=workers)
    compared = op.compare([low], want)
    return dict(workload=workload, seed=seed, seconds=time.perf_counter() - t,
                compared={n: dict(value=v, limit=lim)
                          for n, (v, lim) in compared.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
