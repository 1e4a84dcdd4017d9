#!/usr/bin/env python3
"""Where the device time goes in qvz_tpu_torch's encode or decode, on one
GPU.

    python3 scripts/profile_torch_encode.py [--no-prime] [-c K] [--decode]

Encodes the input of chip_smoke.py (1,000,000 x 100, seed 42, -f 0.5,
--shards 0, -c K -T 4 with K = 1 by default) once to warm up, then once
under torch.profiler. With --decode, it decodes that container on the
card once to warm up, then once under the profiler. Prints the
wall time, the union of the device's activity (kernels and copies), the
idle share and the device time by kernel name. The profiler's own cost
is in these numbers; the end-to-end metric comes from chip_smoke.py,
which runs without it.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--no-prime", action="store_true")
    ap.add_argument("-c", dest="clusters", type=int, default=1)
    ap.add_argument("--decode", action="store_true",
                    help="profile the decode of the encoded container")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_encode: no CUDA device is visible",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_input, smi
    from qvz_tpu_torch.constants import DISTORTION_MSE
    from qvz_tpu_torch.ops.distortion import make_matrix
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline.decode import decode
    from qvz_tpu_torch.pipeline.encode import encode

    data = make_input(1_000_000, 100, 42)
    dist = make_matrix(DISTORTION_MSE)

    def run_encode():
        return encode(data, dist, n_clusters=args.clusters,
                      cluster_threshold=4.0, well_state=WellState.debug(),
                      shards=0, prime=not args.no_prime, want_recon=False,
                      device="cuda")

    def run_decode():
        st: dict = {}
        decode(container, device="cuda", stats=st)
        return st["phase_seconds"]

    if args.decode:
        container = run_encode().compressed
        run = run_decode
    else:
        def run():
            return run_encode().stats.phase_seconds
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        phase_seconds = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    by_name: collections.Counter = collections.Counter()
    for lo, hi, name in spans:
        by_name[name] += hi - lo
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    busy /= 1e6
    print(f"card: {smi()}")
    phases = {k: round(v, 4) for k, v in phase_seconds.items()}
    print(f"{'decode' if args.decode else 'encode'} -c {args.clusters} "
          f"prime={not args.no_prime}: wall "
          f"{wall:.4f} s (profiler on); "
          f"phases {phases}")
    if not spans:
        print("device time: not measured (the profiler saw no device "
              "events)")
        return 0
    print(f"device busy {busy:.4f} s = {100 * busy / wall:.1f}% of the "
          f"wall time; idle {100 * (1 - busy / wall):.1f}%; "
          f"{len(spans)} device events")
    for name, us in by_name.most_common(12):
        print(f"  {us / 1e3:10.3f} ms  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
