#!/usr/bin/env python3
"""The lanes that the device encode and decode of phase 17 send to the
host, on one GPU.

    python3 scripts/phase17_counts_torch.py

Writes chip_smoke.py's phase-17 input (11,000,000 x 100 reads, 1.111 GB,
under build/) and runs two of that phase's child interpreters of the CLI
(chip_smoke.STREAM_CHILD): B, the in-memory device encode at -f 0.5
--debug-seed --shards 512 -s -v -u, and C, -x of B's container on the
card. Prints the card's name and power limit, then one JSON line: B's
coder_fallback_lanes, the seconds and calls of its host re-coding of
flagged lanes, its phases and seconds; C's fallback_lanes, phases and
seconds; and whether C's text equals B's -u file. The directory is
removed after. Without a card it exits 1. chip_smoke.py runs the whole
phase and its checks; this script only counts.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("phase17_counts_torch: no CUDA device is visible",
              file=sys.stderr)
        return 1
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    td = tempfile.mkdtemp(prefix="count17_", dir=os.path.join(ROOT, "build"))
    try:
        src = os.path.join(td, "in")
        size = cs.write_stream_input(np, None, src)
        q, u, dec = (os.path.join(td, k) for k in ("B.q", "B.u", "B.dec"))
        b, b_out = cs._child(
            ["-f", "0.5", "--debug-seed", "--shards", str(cs.STREAM_SHARDS),
             "-s", "-v", "-u", u, src, q],
            {"QVZ_TPU_STREAM_MIN_BYTES": str(size + 1)})
        c, _ = cs._child(["-x", q, dec], {})
        print(json.dumps({
            "card": smi, "bytes": size,
            "B": {"secs": b["secs"], **b["seen"]},
            "C": {"secs": c["secs"], **c["seen"]},
            "C_equals_B_u": cs.same_file(dec, u)}), flush=True)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
