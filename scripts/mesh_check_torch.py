#!/usr/bin/env python3
"""The port's multi-device paths across every visible card of one host.

    python3 scripts/mesh_check_torch.py

On chip_smoke.py's input (1,000,000 reads x 100 columns of Illumina-like
scores from seed 42, -f 0.5, MSE, the debug WELL seed), with N >= 2
cards:

1. ``pipeline.encode.encode(mesh=make_mesh())``, one block of reads a
   card: -c 1 and -c 3 -T 4, primed at --shards 0, each byte-equal to the
   one-device encode on cuda:0, with K4 (each step), K3, K1, K2a and K2b
   launched on every block. The -c 3 one-device encode on the last card
   is byte-equal too, and the -c 3 mesh container decodes there (K5) to
   the host decoder's bytes. Each encode's wall time and phase split are
   printed, one run each: a check, not a benchmark.
2. ``parallel.distributed`` over NCCL: N child interpreters (chip_smoke's
   DIST_CHILD), each on the card ``initialize`` picks for its rank, with
   an even share of the reads and their k-means ids, K3 and one
   all-reduce: every rank gets the one-device counts of all the reads.

Exits non-zero on any failure, and where fewer than two cards are
visible.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from chip_smoke import require  # noqa: E402
from qvz_tpu_torch import _build  # noqa: E402
from qvz_tpu_torch.constants import DISTORTION_MSE  # noqa: E402
from qvz_tpu_torch.ops import kmeans, stats  # noqa: E402
from qvz_tpu_torch.ops.distortion import make_matrix  # noqa: E402
from qvz_tpu_torch.ops.well import WellState  # noqa: E402
from qvz_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from qvz_tpu_torch.pipeline import decode as port_dec  # noqa: E402
from qvz_tpu_torch.pipeline import encode as port  # noqa: E402
from qvz_tpu_torch.pipeline import host  # noqa: E402


def encodes(data, dist, mesh) -> None:
    """Check 1: the mesh encodes against the one-device ones."""
    cards = mesh.size
    last = str(mesh.devices[-1])
    for name, kw in (("-c 1", dict(shards=0)),
                     ("-c 3 -T 4", dict(n_clusters=3, cluster_threshold=4.0,
                                        shards=0))):
        t = time.perf_counter()
        one = port.encode(data, dist, well_state=WellState.debug(),
                          want_recon=False, device="cuda:0", **kw)
        one_s = time.perf_counter() - t
        _build.LAUNCHES.clear()
        t = time.perf_counter()
        got = port.encode(data, dist, well_state=WellState.debug(),
                          want_recon=False, mesh=mesh, **kw)
        secs = time.perf_counter() - t
        launches = dict(_build.LAUNCHES)
        require(got.compressed == one.compressed,
                f"{name} over {cards} cards: byte-equal to the one-device "
                "encode")
        require(all(launches.get(k, 0) >= cards for k in
                    ("hist", "quantize", "coder_triples", "coder_chain"))
                and (launches.get("kmeans", 0) >= cards
                     or "n_clusters" not in kw),
                f"{name}: every kernel launched on each of the {cards} "
                f"blocks ({launches})")
        print(json.dumps({"encode": name, "cards": cards,
                          "mesh_s": secs, "one_device_s": one_s,
                          "launches": launches,
                          "phases": got.stats.phase_seconds,
                          "one_device_phases": one.stats.phase_seconds}),
              flush=True)
        if "n_clusters" in kw:
            _build.LAUNCHES.clear()
            alone = port.encode(data, dist, well_state=WellState.debug(),
                                want_recon=False, device=last, **kw)
            require(alone.compressed == one.compressed
                    and _build.LAUNCHES["hist"] == 1,
                    f"{name} on {last} alone: byte-equal, K3 once")
            _build.LAUNCHES.clear()
            st = {}
            dec = port_dec.decode(got.compressed, device=last, stats=st)
            require(_build.LAUNCHES["decoder"] >= 1
                    and st["fallback_lanes"] == 0
                    and np.array_equal(dec, host.decode(got.compressed)),
                    f"{name}: the mesh container decodes on {last} (K5) to "
                    "the host decoder's bytes")


def main() -> int:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < 2:
        print(f"mesh_check_torch: needs at least two cards, {have} visible",
              file=sys.stderr)
        return 1
    mesh = make_mesh()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, cards {list(map(str, mesh.devices))}",
          flush=True)
    data = chip_smoke.make_input(1_000_000, 100, 42)
    dist = make_matrix(DISTORTION_MSE)
    encodes(data, dist, mesh)
    # check 2: the counts every rank must get, from one device
    dt = torch.from_numpy(np.ascontiguousarray(data.T)).to("cuda:0")
    ids, _, _ = kmeans.kmeans_cluster(data, 3, 4.0, data_t=dt)
    counts = tuple(t.cpu().numpy() for t in
                   stats.conditional_counts_t(dt, ids, 3))
    del dt
    chip_smoke.run_ranks(np, data, ids.cpu().numpy(), counts, dist,
                         mesh.size, "nccl", have, "[mesh]")
    print("mesh_check_torch: every check held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
