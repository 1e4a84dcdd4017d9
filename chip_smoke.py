#!/usr/bin/env python3
"""Quickest proof that qvz_tpu_torch runs on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Drives the port's main paths, the device QVZ2 encode with one cluster
and with k-means clustering (-c 3 -T 4) and the device decode of their
containers, at a full-size input: 1,000,000 reads x 100 columns of
Illumina-like quality scores made from seed 42, -f 0.5, MSE, --shards 0
(the device lane count), priming on and off, the debug WELL seed.
Phases:

  0. the card (nvidia-smi name and power limit), torch, CUDA and nvcc
  1. build the five kernels (csrc/quantize.cu K1, csrc/coder.cu K2,
     csrc/hist.cu K3, csrc/kmeans.cu K4, csrc/decoder.cu K5) from the
     sources for sm_90a, one nvcc per source in parallel, with the ptxas
     report
  2. the input; device statistics (K3, one cluster) checked equal to the
     host C++ counts; codebook design
  3. K1 against its plain PyTorch version at the full shape: element-equal
  4. K2 against its plain version on the slice's lane plan: words, carry
     and flags equal lane by lane, payload bytes equal
  5. the end-to-end encode, -c 1, through
     qvz_tpu_torch.pipeline.encode.encode, timed as the median of 5 runs
     without -u (the phase split is the last run's): the container
     byte-equal to the port's host engine (qvz_tpu_torch.pipeline.host,
     pure C++, held byte-equal to qvz_tpu's by the CPU tests) for the same
     shards, priming and seed; decoded by the host decoder to the
     port's reconstruction; -s figures equal; hist, quantize and coder
     launched by the encode itself
  6. K4, one k-means step at K = 3 from seed_centroids, against its plain
     version (assign, sums and counts equal), also with two identical
     means (every tie to the lower index); then kmeans_cluster on the
     card against the host C++ rt.kmeans_host: equal assignment, means
     and iteration count
  7. K3 against its plain version and rt.stats_host, with one cluster and
     with the k-means ids of phase 6; torch.bincount over the combined
     (column, cluster*72 + previous, current) index, timed as K3's library
     yardstick (the port never calls it)
  8. K1 with the k-means ids against its plain version at the full shape
  9. K2 with the cluster-id segment against its plain version, on the
     segment and the first columns (the plain loop over all 100 columns
     would take another ~50 s); the kernel's time is over all columns
 10. the end-to-end encode, -c 3 -T 4, median of 3 runs without -u, primed
     and unprimed: checked as in 5 against the port's host engine with
     n_clusters=3; hist, kmeans, quantize and coder launched by the encode
 11. K5 against its plain version on the lanes of the four containers of
     phases 5 and 10: on the first 2 columns of every lane the rows, the
     final (l, u, t, bit position) and the flags equal, and over all
     columns for the -c 1 primed container (the plain loop takes tens of
     seconds there); the kernel timed over all columns; the -c 3 lanes
     start mid-byte after their host cluster-id prologue
 12. the end-to-end decode of those containers through
     qvz_tpu_torch.pipeline.decode.decode(device="cuda"), median of 3
     runs beside the port's host decoder in the same call: byte-equal to
     it and to the encode's -u reconstruction + 33, no lane flagged (K2
     flagged none, and the flags are the encode's own rescale
     condition), the decoder launched by the decodes
 13. 300,000 x 2 at --shards 2, unprimed, whose two lanes reach the
     rescale: flagged, decoded again on the host, byte-equal
 14. K5 over all columns of the four containers at 32, 16, 8, 4, 2 and 1
     lanes a warp: equal output, median of 3 each

Times are CUDA-event times after a warm-up, kernel and plain version
measured in turns. Each kernel's bound is the larger of its bytes (each
input read once, each output written once) over 3.35 TB/s and its int32
operations over the card's SMs x 64 lanes x top SM clock. Every check
that fails raises, so the script exits non-zero. The last two lines are
the kernels' JSON record and the result line {"ok": true, "device":
{...}}. Without a CUDA device, or without the rest of the repository,
the script fails before it prints any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


# The card's peak rates for the kernels' bounds: device memory at 3.35
# TB/s (NVIDIA's data sheet for the H100 SXM), and int32 operations at the
# card's SMs x 64 int32 lanes x its top SM clock (read from the card). The
# lane coder and decoder do about STEP_OPS int32 operations a step (the
# model lookup, the count search and update, two products and divisions,
# the renormalisation; csrc/coder.cu, csrc/decoder.cu).
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
STEP_OPS = 100
LANES_SWEEP = (32, 16, 8, 4, 2, 1)


def int32_ops_per_s(torch) -> float:
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    return (torch.cuda.get_device_properties(0).multi_processor_count
            * INT32_LANES_PER_SM * mhz * 1e6)


def bound(nbytes: float, ops: float, ops_rate: float):
    """(least ms, "bytes" or "operations"): each input read once, each
    output written once, over the memory rate, against the operations
    over the int32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k5_bound(lanes, cols: int, ops_rate: float):
    """K5 over all columns: the lanes' draws, payloads and cluster ids in,
    the text rows and states out; STEP_OPS a step."""
    n = int(sum(lanes.lane_counts))
    nbytes = (n * cols + int(lanes.pays.lens.sum())
              + (n if lanes.cl is not None else 0) + n * (cols + 1)
              + len(lanes.lane_counts) * (4 + 5) * 8)
    return bound(nbytes, n * cols * STEP_OPS, ops_rate)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def event_ms(fn, torch) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def make_input(n: int, cols: int, seed: int):
    """Illumina-like quality symbols (the generator of the repository's
    verify recipe): a random start, +-2 steps, a drift down the read,
    clipped to Phred 2..41."""
    import numpy as np
    rng = np.random.default_rng(seed)
    start = rng.integers(28, 40, size=(n, 1))
    steps = rng.integers(-2, 3, size=(n, cols - 1)) \
        - (np.arange(cols - 1) // 40)
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 2,
                   41).astype(np.uint8)


def in_turns(kernel, plain, torch, runs: int = 5):
    """Median CUDA-event ms of kernel and plain, run in turns after one
    warm-up of each; also returns the runs."""
    kernel()
    plain()
    ks, ps = [], []
    for _ in range(runs):
        ks.append(event_ms(kernel, torch))
        ps.append(event_ms(plain, torch))
    return statistics.median(ks), statistics.median(ps), ks, ps


def max_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def clustered_phases(torch, np, data, dist, card, rate) -> dict:
    """Phases 6-10: the -c 3 -T 4 path. Returns the kernels' errors and
    times, the encodes' medians and the encodes' kernel launches."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.constants import MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import kmeans as tk
    from qvz_tpu_torch.ops import quantize as tq
    from qvz_tpu_torch.ops import stats as ts
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host
    from qvz_tpu_torch.spec.kmeans import seed_centroids

    K, T = 3, 4.0
    dev = torch.device("cuda")
    n, cols = data.shape
    data_t = torch.from_numpy(np.ascontiguousarray(data.T)).to(dev)
    res = {}

    # -- 6. K4 -------------------------------------------------------------
    seeds = seed_centroids(data, K).astype(np.int64)
    means = torch.from_numpy(seeds).to(dev)
    got = tk.kmeans_step(data_t, means)
    want = tk.kmeans_step_reference(data_t, means)
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(err == 0 and all(torch.equal(a, b) for a, b in zip(got, want)),
            "K4 assign, sums and counts equal the plain version's")
    tie = seeds.copy()
    tie[1] = tie[0]
    tie_t = torch.from_numpy(tie).to(dev)
    got = tk.kmeans_step(data_t, tie_t)
    want = tk.kmeans_step_reference(data_t, tie_t)
    torch.cuda.synchronize()
    err = max(err, max_err(got, want))
    require(all(torch.equal(a, b) for a, b in zip(got, want))
            and int(got[2][1]) == 0 and int(got[2][0]) > 0,
            "K4 with two identical means gives every tie to the lower one")
    k4, k4_plain, k4_runs, k4_plain_runs = in_turns(
        lambda: tk.kmeans_step(data_t, means),
        lambda: tk.kmeans_step_reference(data_t, means), torch)
    t = time.perf_counter()
    assign_dev, km_means, iters = tk.kmeans_cluster(data, K, T,
                                                    data_t=data_t)
    torch.cuda.synchronize()
    km_secs = time.perf_counter() - t
    t = time.perf_counter()
    h_assign, h_means, h_iters = rt.kmeans_host(data, K, T)
    host_secs = time.perf_counter() - t
    clusters = assign_dev.cpu().numpy()
    require(np.array_equal(clusters, h_assign)
            and np.array_equal(km_means, h_means) and iters == h_iters,
            "kmeans_cluster on the card equals rt.kmeans_host")
    sizes = np.bincount(clusters, minlength=K).tolist()
    res.update(k4_err=err, k4_ms=k4, k4_plain_ms=k4_plain,
               k4_bound=bound(n * cols + 4 * n + 16 * K * cols + 8 * K,
                              3 * n * K * cols, rate))
    print(f"[6] K4 k-means step {n} x {cols}, K={K}: equal (max abs err "
          f"{err}), ties to the lower index; kernel {k4:.3f} ms, plain "
          f"{k4_plain:.3f} ms (median of 5, in turns); kernel {k4_runs}, "
          f"plain {k4_plain_runs}", flush=True)
    print(f"[6] kmeans_cluster -T {T:g}: {iters} iterations, cluster sizes "
          f"{sizes}, equal to rt.kmeans_host ({h_iters} iterations); "
          f"{km_secs:.4f} s on the card, {host_secs:.4f} s on the host",
          flush=True)

    # -- 7. K3 -------------------------------------------------------------
    cl_t = assign_dev
    err = 0
    k3_times = {}
    for c, ids, ids_h in ((1, None, None), (K, cl_t, clusters)):
        got = ts.conditional_counts_t(data_t, ids, c)
        want = ts.conditional_counts_reference(data_t, ids, c)
        torch.cuda.synchronize()
        counts_h = rt.stats_host(data, ids_h, c)
        err = max(err, max_err(got, want))
        require(all(torch.equal(a, b) for a, b in zip(got, want))
                and all(np.array_equal(a.cpu().numpy(), b)
                        for a, b in zip(got, counts_h)),
                f"K3 with {c} clusters equals its plain version and "
                "rt.stats_host")
        k3_times[c] = in_turns(
            lambda: ts.conditional_counts_t(data_t, ids, c),
            lambda: ts.conditional_counts_reference(data_t, ids, c), torch)
        print(f"[7] K3 histograms {cols} x {n}, C={c}: equal to the plain "
              f"version and rt.stats_host (max abs err {err}); kernel "
              f"{k3_times[c][0]:.3f} ms, plain {k3_times[c][1]:.3f} ms "
              f"(median of 5, in turns); kernel {k3_times[c][2]}, plain "
              f"{k3_times[c][3]}", flush=True)
    res.update(k3_err=err, k3_ms=k3_times[K][0], k3_plain_ms=k3_times[K][1],
               k3_c1_ms=k3_times[1][0], k3_c1_plain_ms=k3_times[1][1])
    # the library yardstick: one torch.bincount over the combined
    # (column, cluster*72 + previous, current) index (the port never calls
    # it); the index is built outside the timing
    A = 72
    idx = ((cl_t.long() * A + data_t[:-1].long()) * A + data_t[1:].long()
           + torch.arange(cols - 1, device=dev)[:, None] * (K * A * A)
           ).reshape(-1)
    lib_cond = torch.bincount(idx, minlength=(cols - 1) * K * A * A)
    k3_cond = ts.conditional_counts_t(data_t, cl_t, K)[1]
    require(torch.equal(lib_cond.reshape(cols - 1, K, A, A).permute(
        1, 0, 2, 3), k3_cond), "torch.bincount gives K3's counts")
    res["k3_lib_ms"] = statistics.median(event_ms(
        lambda: torch.bincount(idx, minlength=(cols - 1) * K * A * A),
        torch) for _ in range(5))
    res["k3_bound"] = bound(
        n * cols + n + K * (cols - 1) * A * A * 8 + K * A * 8, n * cols * 4,
        rate)
    print(f"[7] torch.bincount over the combined index, C={K}: "
          f"{res['k3_lib_ms']:.3f} ms (median of 5), equal to K3; K3 bound "
          f"{res['k3_bound'][0]:.4f} ms ({res['k3_bound'][1]})", flush=True)
    del idx, lib_cond, k3_cond

    # -- 8. K1 with the cluster ids -----------------------------------------
    c0, cond = ts.conditional_counts_t(data_t, cl_t, K)
    tables = rt.Design(c0.cpu().numpy(), cond.cpu().numpy(), MODE_RATIO,
                       0.5, dist).tables()
    counts, states, offs, prime_on = port.shard_plan(
        n, cols, port.device_lane_count(n), True, WellState.debug())
    draws = host._shard_draws(states, counts, cols)
    draws_t = torch.from_numpy(draws).to(dev).t().contiguous()
    tabs = tq.tables_to_torch(tables, dev)
    got = tq.quantize_t_device(tabs, data_t, draws_t, cl_t)
    want = tq.quantize_reference(tabs, data_t, draws_t, cl_t)
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(err == 0 and all(torch.equal(a, b) for a, b in zip(got, want)),
            "K1 with cluster ids equals its plain version")
    k1c, k1c_plain, _, _ = in_turns(
        lambda: tq.quantize_t_device(tabs, data_t, draws_t, cl_t),
        lambda: tq.quantize_reference(tabs, data_t, draws_t, cl_t), torch)
    res["k1_err"] = err
    print(f"[8] K1 quantize with {K} clusters {cols} x {n}: equal (max abs "
          f"err {err}); kernel {k1c:.3f} ms, plain {k1c_plain:.3f} ms "
          f"(median of 5, in turns)", flush=True)
    mid, qs, _ = got
    del want, draws_t

    # -- 9. K2 with the cluster-id segment -----------------------------------
    w_n = int(counts[0])
    md0, qs0, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data[:w_n].T), clusters[:w_n],
        states[0])
    plan = cd.LanePlan(tables, rt.bank_from_stream(
        tables, md0, qs0, clusters[:w_n], w_n))
    plan_t = cd.plan_to_torch(plan, dev)
    lane_counts, base = counts[1:], int(offs[1])
    ctrip = np.zeros((len(lane_counts), max(lane_counts), 3), np.uint32)
    for w in range(len(lane_counts)):
        lo, hi = int(offs[1 + w]), int(offs[2 + w])
        ctrip[w, : hi - lo] = rt.replay_model(
            plan.cluster_init_counts, plan.cluster_init_total,
            clusters[lo:hi])
    k = 2
    plan_k = dict(plan_t, columns=k)
    mid_k, qs_k = mid[:k].contiguous(), qs[:k].contiguous()
    got = cd.fetch_lanes(*cd.code_lanes(plan_k, mid_k, qs_k, lane_counts,
                                        base, ctrip))
    t = time.perf_counter()
    want = cd.fetch_lanes(*cd.encode_lanes_reference(
        plan_k, mid_k, qs_k, lane_counts, base, ctrip))
    seg_plain = (time.perf_counter() - t) * 1e3
    pk, fk = cd.payloads_from_raw(*got)
    pp, fp = cd.payloads_from_raw(*want)
    ok = ~fk
    err = max([int(np.abs(got[0][w, : got[1][w]].astype(np.int64)
                          - want[0][w, : want[1][w]].astype(np.int64)).max())
               for w in np.flatnonzero(ok) if got[1][w]] + [0])
    err = max(err, int(np.abs(got[2][:5, ok] - want[2][:5, ok]).max()))
    require(np.array_equal(fk, fp) and np.array_equal(got[1], want[1])
            and err == 0 and pk == pp,
            "K2 with the cluster-id segment equals its plain version")
    res["k2_err"] = err
    seg_ms = statistics.median(
        event_ms(lambda: cd.code_lanes(plan_t, mid, qs, lane_counts, base,
                                       ctrip), torch) for _ in range(3))
    print(f"[9] K2 with the cluster-id segment, {len(lane_counts)} lanes: "
          f"segment + {k} columns equal to the plain version (max abs err "
          f"{err}, {int(fk.sum())} flagged lanes; plain {seg_plain:.1f} "
          f"ms); kernel over the segment and all {cols} columns "
          f"{seg_ms:.3f} ms (median of 3)", flush=True)
    del mid, qs, got, want, data_t

    # -- 10. the end-to-end encode, -c 3 -T 4 -------------------------------
    mb = n * (cols + 1) / 1e6
    _build.LAUNCHES.clear()
    res["e2e"] = {}
    for prime in (True, False):
        kw = dict(n_clusters=K, cluster_threshold=T,
                  well_state=WellState.debug(), shards=0, prime=prime)
        out = port.encode(data, dist, want_recon=True, device="cuda", **kw)
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            fast = port.encode(data, dist, want_recon=False, device="cuda",
                               **kw)
            runs.append(time.perf_counter() - t)
        secs = statistics.median(runs)
        kw["shards"] = port.device_lane_count(n)
        ref = host.encode(data, dist, want_recon=False, **kw)
        require(out.compressed == ref.compressed,
                f"-c 3 prime={prime}: container byte-equal to the port's "
                "host engine")
        require(fast.compressed == out.compressed
                and np.array_equal(out.clusters, ref.clusters),
                f"-c 3 prime={prime}: repeated encode byte-equal, clusters "
                "equal")
        dec = host.decode(out.compressed)
        require(np.array_equal(dec[:, :cols], out.reconstructed + 33),
                f"-c 3 prime={prime}: host decode equals the -u "
                "reconstruction")
        for o in (out, fast):
            require(f"{o.stats.rate:.4f} {o.stats.distortion:.4f} "
                    f"{o.stats.payload_bytes}"
                    == f"{ref.stats.rate:.4f} {ref.stats.distortion:.4f} "
                    f"{ref.stats.payload_bytes}",
                    f"-c 3 prime={prime}: -s rate, distortion and size "
                    "equal")
        phases = {k: round(v, 6) for k, v in fast.stats.phase_seconds.items()}
        res["e2e"][prime] = secs
        res.setdefault("containers", {})[f"-c 3 prime={prime}"] = (
            out.compressed, out.reconstructed)
        print(f"[10] -c 3 prime={prime}: {len(ref.compressed)} B container "
              f"byte-equal, decoded equal; encode median of 3 {secs:.4f} s "
              f"= {mb / secs:.1f} MB/s (runs {[round(r, 4) for r in runs]}"
              f"); rate {fast.stats.rate:.4f} distortion "
              f"{fast.stats.distortion:.4f}; host-fallback lanes "
              f"{fast.stats.coder_fallback_lanes}; phases "
              f"{json.dumps(phases)}", flush=True)
    res["launches"] = dict(_build.LAUNCHES)
    print(f"[10] kernel launches by the -c 3 encodes: {res['launches']}")
    for name in ("hist", "kmeans", "quantize", "coder"):
        require(res["launches"].get(name, 0) >= 1,
                f"the -c 3 encode launched {name}")
    return res


def decode_phases(torch, np, containers, dist, rate) -> dict:
    """Phases 11-13: the device decode of the four containers of phases 5
    and 10, and a container whose lanes reach the rescale. Returns K5's
    error and times, the decodes' medians and their kernel launches."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import decode as port
    from qvz_tpu_torch.pipeline import host

    res = {"err": 0, "ms": {}, "plain_ms": {}, "all_ms": {}, "e2e": {},
           "sweep": {}}

    # -- 11. K5 against its plain version ------------------------------------
    for name, (comp, _) in containers.items():
        lanes = port.prepare_lanes(comp, "cuda")
        n, cols = lanes.draws_t.shape[1], lanes.dplan_t["columns"]
        outs = {}

        def run(fn, key, cols_run=2, **kw):
            out = torch.zeros((n, cols + 1), dtype=torch.uint8,
                              device="cuda")
            outs[key] = (fn(lanes.dplan_t, lanes.pays, lanes.draws_t,
                            lanes.cl, lanes.lane_counts, 0, lanes.starts,
                            out, 33, cols_run, **kw), out)

        def kernel():
            run(dd.decode_lanes_t, "kernel")

        def plain():
            run(dd.decode_lanes_reference, "plain")

        k5, k5_plain, _, _ = in_turns(kernel, plain, torch, runs=2)
        (fk, ok), (fp, op) = outs["kernel"], outs["plain"]
        err = max(int((fk - fp).abs().max()),
                  int((ok.long() - op.long()).abs().max()))
        require(err == 0 and torch.equal(fk, fp) and torch.equal(ok, op),
                f"{name}: K5 rows, final (l, u, t, bit position) and flags "
                "equal the plain version's on 2 columns")
        all_ms = statistics.median(event_ms(
            lambda: run(dd.decode_lanes_t, "all", None), torch)
            for _ in range(3))
        if name.startswith("-c 3"):
            require(bool((lanes.starts[:, 3] % 8 != 0).any()),
                    f"{name}: some prologue lanes start mid-byte")
        steps = cols * max(lanes.lane_counts)
        line = (f"[11] K5 {name}: {len(lanes.lane_counts)} lanes, 2 columns "
                f"equal to the plain version (max abs err {err}, "
                f"{int((fk[:, 4] != 0).sum())} flagged lanes); 2 columns: "
                f"kernel {k5:.3f} ms, plain {k5_plain:.3f} ms (median of 2, "
                f"in turns); all {cols} columns ({steps} steps a lane): "
                f"kernel {all_ms:.3f} ms (median of 3)")
        if name == "-c 1 prime=True":
            # the plain version over all columns, once: the kernel's
            # yardstick at the main path's shape
            t = time.perf_counter()
            run(dd.decode_lanes_reference, "plain_all", None)
            res["plain_all_ms"] = (time.perf_counter() - t) * 1e3
            (fa, oa), (fpa, opa) = outs["all"], outs["plain_all"]
            err = max(err, int((fa - fpa).abs().max()),
                      int((oa.long() - opa.long()).abs().max()))
            require(err == 0, f"{name}: K5 equals its plain version over "
                    "all columns")
            res["bound"] = k5_bound(lanes, cols, rate)
            line += (f"; plain over all columns {res['plain_all_ms']:.1f} "
                     f"ms, equal; bound {res['bound'][0]:.4f} ms "
                     f"({res['bound'][1]})")
        print(line, flush=True)
        res["err"] = max(res["err"], err)
        res["ms"][name], res["plain_ms"][name] = k5, k5_plain
        res["all_ms"][name] = all_ms
        del lanes, outs

    # -- 12. the end-to-end decode ------------------------------------------
    _build.LAUNCHES.clear()
    for name, (comp, recon) in containers.items():
        n, cols = recon.shape
        t = time.perf_counter()
        want = host.decode(comp)
        host_secs = time.perf_counter() - t
        require(np.array_equal(want[:, :cols], recon + 33),
                f"{name}: the host decoder gives the encode's -u "
                "reconstruction")
        st = {}
        got = port.decode(comp, device="cuda", stats=st)
        require(np.array_equal(got, want),
                f"{name}: decode(device='cuda') byte-equal to the host "
                "decoder")
        require(st["fallback_lanes"] == 0,
                f"{name}: no lane flagged ({st['fallback_lanes']} of "
                f"{st['lanes']})")
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            port.decode(comp, device="cuda", stats=st)
            runs.append(time.perf_counter() - t)
        secs = statistics.median(runs)
        mb = n * (cols + 1) / 1e6
        res["e2e"][name] = (secs, host_secs)
        phases = {k: round(v, 6) for k, v in st["phase_seconds"].items()}
        print(f"[12] decode {name}: byte-equal to the host decoder and the "
              f"-u reconstruction, {st['lanes']} lanes, 0 flagged; median "
              f"of 3 {secs:.4f} s = {mb / secs:.1f} MB/s (runs "
              f"{[round(r, 4) for r in runs]}); host decoder {host_secs:.4f}"
              f" s = {mb / host_secs:.1f} MB/s; phases "
              f"{json.dumps(phases)}", flush=True)
    res["launches"] = dict(_build.LAUNCHES)
    print(f"[12] kernel launches by the decodes: {res['launches']}")
    require(res["launches"].get("decoder", 0) >= 1,
            "the decode launched the decoder")

    # -- 13. lanes that reach the rescale fall back to the host --------------
    rng = np.random.default_rng(1)
    data = np.clip(30 + rng.integers(-1, 2, size=(300_000, 2)).cumsum(1), 0,
                   71).astype(np.uint8)
    comp = host.encode(data, dist, well_state=WellState.debug(), shards=2,
                       prime=False).compressed
    st = {}
    got = port.decode(comp, device="cuda", stats=st)
    require(st["fallback_lanes"] >= 1, "a lane reaching the rescale is "
            "flagged")
    require(np.array_equal(got, host.decode(comp)),
            "the fallback decode is byte-equal to the host decoder")
    print(f"[13] 300000 x 2, 2 lanes: {st['fallback_lanes']} flagged and "
          f"decoded again on the host, byte-equal; phases "
          f"{json.dumps({k: round(v, 6) for k, v in st['phase_seconds'].items()})}",
          flush=True)

    # -- 14. K5 at each lanes-a-warp setting -------------------------------
    for name, (comp, _) in containers.items():
        lanes = port.prepare_lanes(comp, "cuda")
        n, cols = lanes.draws_t.shape[1], lanes.dplan_t["columns"]
        first = None
        for lpw in LANES_SWEEP:
            out = torch.zeros((n, cols + 1), dtype=torch.uint8,
                              device="cuda")

            def launch():
                return dd.decode_lanes_t(
                    lanes.dplan_t, lanes.pays, lanes.draws_t, lanes.cl,
                    lanes.lane_counts, 0, lanes.starts, out, 33,
                    lanes_per_warp=lpw)

            fin = launch()
            if first is None:
                first = (fin, out.clone())
            require(torch.equal(fin, first[0]) and torch.equal(out, first[1]),
                    f"{name}: K5 at {lpw} lanes a warp equals K5 at "
                    f"{LANES_SWEEP[0]}")
            res["sweep"].setdefault(name, {})[lpw] = statistics.median(
                event_ms(launch, torch) for _ in range(3))
        print(f"[14] K5 {name} over all columns by lanes a warp (median of "
              f"3, equal output): " + ", ".join(
                  f"{k}: {v:.3f} ms" for k, v in res["sweep"][name].items()),
              flush=True)
        del lanes, first
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from qvz_tpu_torch import _build
    from qvz_tpu_torch.constants import DISTORTION_MSE, MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import quantize as tq
    from qvz_tpu_torch.ops import stats as ts
    from qvz_tpu_torch.ops.distortion import make_matrix
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host

    dev = torch.device("cuda")
    card = smi()
    rate = int32_ops_per_s(torch)

    # -- 0. the card ------------------------------------------------------
    print(f"[0] card: {card}")
    print(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"devices {torch.cuda.device_count()}")
    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    print(f"[0] nvcc: {nv[-1] if nv else '?'}", flush=True)
    print(f"[0] bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s device memory, "
          f"{rate / 1e12:.2f} T int32 operations/s", flush=True)

    # -- 1. build ---------------------------------------------------------
    t = time.perf_counter()
    report = _build.build(_build.lib_path())
    _build.load()
    print(f"[1] built {_build.lib_path().name} from "
          f"{[s.name for s in _build.sources()]} in "
          f"{time.perf_counter() - t:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"[1] {line.strip()}")
    sys.stdout.flush()

    # -- 2. input, statistics, design --------------------------------------
    n, cols = 1_000_000, 100
    data = make_input(n, cols, 42)
    dist = make_matrix(DISTORTION_MSE)
    data_dev = torch.from_numpy(data).to(dev)
    c0, cond = ts.conditional_counts(data_dev, None, 1)
    c0_h, cond_h = rt.stats_host(data, None, 1)
    require(np.array_equal(c0.cpu().numpy(), c0_h)
            and np.array_equal(cond.cpu().numpy(), cond_h),
            "device statistics equal the host counts")
    design = rt.Design(c0.cpu().numpy(), cond.cpu().numpy(), MODE_RATIO,
                       0.5, dist)
    tables = design.tables()
    shards = port.device_lane_count(n)
    counts, states, offs, prime_on = port.shard_plan(
        n, cols, shards, True, WellState.debug())
    require(prime_on, "the slice's plan primes")
    draws = host._shard_draws(states, counts, cols)
    print(f"[2] input {n} x {cols}, {len(counts) - 1} lanes of "
          f"{counts[1]} lines after a {counts[0]}-line warmup; statistics "
          f"equal the host's", flush=True)

    # -- 3. K1 against its plain version ------------------------------------
    tabs = tq.tables_to_torch(tables, dev)
    data_t = data_dev.t().contiguous()
    draws_t = torch.from_numpy(draws).to(dev).t().contiguous()
    got = tq.quantize_t_device(tabs, data_t, draws_t)
    want = tq.quantize_reference(tabs, data_t, draws_t)
    torch.cuda.synchronize()
    k1_err = max(int((a.long() - b.long()).abs().max())
                 for a, b in zip(got, want))
    require(k1_err == 0 and all(torch.equal(a, b)
                                for a, b in zip(got, want)),
            "K1 equals its plain version element for element")
    k1_ms, k1_plain_ms = [], []
    for _ in range(5):
        k1_ms.append(event_ms(
            lambda: tq.quantize_t_device(tabs, data_t, draws_t), torch))
        k1_plain_ms.append(event_ms(
            lambda: tq.quantize_reference(tabs, data_t, draws_t), torch))
    k1 = statistics.median(k1_ms)
    k1_plain = statistics.median(k1_plain_ms)
    # data and draws in, mid, qs and qv (int32) out; about 12 operations
    # a symbol (context, pair, dither choice, two lookups, stores)
    k1_bound = bound(14 * n * cols + sum(int(v.numel() * v.element_size())
                                         for v in tabs.values()
                                         if torch.is_tensor(v)),
                     12 * n * cols, rate)
    print(f"[3] K1 quantize {cols} x {n}: equal (max abs err {k1_err}); "
          f"kernel {k1:.3f} ms, plain {k1_plain:.3f} ms (median of 5, "
          f"in turns); kernel {k1_ms}, plain {k1_plain_ms}; bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]})", flush=True)
    mid, qs, _ = got
    del want

    # -- 4. K2 against its plain version -------------------------------------
    w_n = int(counts[0])
    md0, qs0, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data[:w_n].T), None, states[0])
    bank = rt.bank_from_stream(tables, md0, qs0, None, w_n)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, bank), dev)
    lane_counts, base = counts[1:], int(offs[1])
    # warm-up: the kernel once, the plain version on two columns
    cd.code_lanes(plan_t, mid, qs, lane_counts, base)
    cd.encode_lanes_reference(plan_t, mid[:2].contiguous(),
                              qs[:2].contiguous(), lane_counts, base)
    torch.cuda.synchronize()
    k2_ms = []
    raw = {}

    def run_kernel():
        raw["kernel"] = cd.code_lanes(plan_t, mid, qs, lane_counts, base)

    def run_plain():
        raw["plain"] = cd.encode_lanes_reference(plan_t, mid, qs,
                                                 lane_counts, base)

    k2_ms.append(event_ms(run_kernel, torch))
    k2_plain = event_ms(run_plain, torch)
    k2_ms.append(event_ms(run_kernel, torch))
    k2 = statistics.median(k2_ms)
    wk, nk, ck = cd.fetch_lanes(*raw["kernel"])
    wp, np_, cp = cd.fetch_lanes(*raw["plain"])
    fk, fp = ck[5] != 0, cp[5] != 0
    require(np.array_equal(fk, fp), "K2 flags equal the plain version's")
    ok = ~fk
    require(np.array_equal(nk[ok], np_[ok]), "K2 word counts equal")
    k2_err = 0
    for w in np.flatnonzero(ok):
        a = wk[w, : nk[w]].astype(np.int64)
        b = wp[w, : np_[w]].astype(np.int64)
        if len(a):
            k2_err = max(k2_err, int(np.abs(a - b).max()))
    k2_err = max(k2_err, int(np.abs(ck[:5, ok] - cp[:5, ok]).max()))
    require(k2_err == 0, "K2 words and carry equal the plain version's")
    pk, _ = cd.payloads_from_raw(wk, nk, ck)
    pp, _ = cd.payloads_from_raw(wp, np_, cp)
    require(pk == pp, "K2 payload bytes equal the plain version's")
    steps = cols * max(lane_counts)
    k2_bound = bound(8 * cols * sum(lane_counts)
                     + sum(len(q) for q in pk if q is not None),
                     STEP_OPS * cols * sum(lane_counts), rate)
    print(f"[4] K2 lane coder {len(lane_counts)} lanes x {steps} steps: "
          f"equal (max abs err {k2_err}), {int(fk.sum())} flagged lanes; "
          f"kernel {k2:.3f} ms ({k2_ms}), plain {k2_plain:.3f} ms "
          f"(kernel, plain, kernel); bound {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]})", flush=True)
    del raw, mid, qs, got, data_t, draws_t

    # -- 5. the end-to-end encode -----------------------------------------
    mb = n * (cols + 1) / 1e6
    _build.LAUNCHES.clear()
    e2e = {}
    containers = {}
    for prime in (True, False):
        kw = dict(well_state=WellState.debug(), shards=0, prime=prime)
        out = port.encode(data, dist, want_recon=True, device="cuda", **kw)
        runs = []
        for _ in range(5):
            t = time.perf_counter()
            fast = port.encode(data, dist, want_recon=False,
                               device="cuda", **kw)
            runs.append(time.perf_counter() - t)
        secs = statistics.median(runs)
        ref = host.encode(data, dist, well_state=WellState.debug(),
                          shards=shards, prime=prime, want_recon=False)
        require(out.compressed == ref.compressed,
                f"prime={prime}: container byte-equal to the port's host "
                "engine")
        require(fast.compressed == out.compressed,
                f"prime={prime}: repeated encode byte-equal")
        dec = host.decode(out.compressed)
        require(np.array_equal(dec[:, :cols], out.reconstructed + 33),
                f"prime={prime}: host decode equals the -u reconstruction")
        for o in (out, fast):
            require(f"{o.stats.rate:.4f} {o.stats.distortion:.4f} "
                    f"{o.stats.payload_bytes}"
                    == f"{ref.stats.rate:.4f} {ref.stats.distortion:.4f} "
                    f"{ref.stats.payload_bytes}",
                    f"prime={prime}: -s rate, distortion and size equal")
        phases = {k: round(v, 6) for k, v in fast.stats.phase_seconds.items()}
        e2e[prime] = secs
        containers[f"-c 1 prime={prime}"] = (out.compressed,
                                             out.reconstructed)
        print(f"[5] prime={prime}: {len(ref.compressed)} B container "
              f"byte-equal, decoded equal; encode median of 5 {secs:.4f} s "
              f"= {mb / secs:.1f} MB/s (runs {[round(r, 4) for r in runs]}"
              f"); rate {fast.stats.rate:.4f} "
              f"distortion {fast.stats.distortion:.4f}; host-fallback "
              f"lanes {fast.stats.coder_fallback_lanes}; phases "
              f"{json.dumps(phases)}", flush=True)
    launches = dict(_build.LAUNCHES)
    print(f"[5] kernel launches by the encodes: {launches}")
    for name in ("hist", "quantize", "coder"):
        require(launches.get(name, 0) >= 1, f"the encode launched {name}")

    # -- 6.-10. the clustered path (-c 3 -T 4) -----------------------------
    clus = clustered_phases(torch, np, data, dist, card, rate)
    for name, k in clus["launches"].items():
        launches[name] = launches.get(name, 0) + k
    containers.update(clus.pop("containers"))

    # -- 11.-13. the device decode -------------------------------------------
    dec = decode_phases(torch, np, containers, dist, rate)
    launches["decoder"] = dec["launches"]["decoder"]
    require("jax" not in sys.modules, "no JAX imported")

    kernels = [
        {"name": "quantize", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/quantize.cu",
         "replaces": "qvz_tpu/ops/quantize_pallas.py:292",
         "launches": launches["quantize"],
         "max_abs_err": max(k1_err, clus["k1_err"]),
         "ms": k1, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "coder", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/coder.cu",
         "replaces": "qvz_tpu/ops/coder_pallas.py:159",
         "launches": launches["coder"],
         "max_abs_err": max(k2_err, clus["k2_err"]),
         "ms": k2, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "hist", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/hist.cu",
         "replaces": "qvz_tpu/ops/pallas_kernels.py:168",
         "launches": launches["hist"], "max_abs_err": clus["k3_err"],
         "ms": clus["k3_ms"], "plain_ms": clus["k3_plain_ms"],
         "bound_ms": clus["k3_bound"][0], "bound_by": clus["k3_bound"][1],
         "library_ms": clus["k3_lib_ms"]},
        {"name": "kmeans", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/kmeans.cu",
         "replaces": "qvz_tpu/ops/pallas_kernels.py:33",
         "launches": launches["kmeans"], "max_abs_err": clus["k4_err"],
         "ms": clus["k4_ms"], "plain_ms": clus["k4_plain_ms"],
         "bound_ms": clus["k4_bound"][0], "bound_by": clus["k4_bound"][1],
         "library_ms": None},
        {"name": "decoder", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/decoder.cu",
         "replaces": "qvz_tpu/ops/decoder_pallas.py:149",
         "launches": launches["decoder"], "max_abs_err": dec["err"],
         "ms": dec["all_ms"]["-c 1 prime=True"],
         "plain_ms": dec["plain_all_ms"], "bound_ms": dec["bound"][0],
         "bound_by": dec["bound"][1], "library_ms": None},
    ]
    print(f"e2e encode MB/s: -c 1 prime on {mb / e2e[True]:.1f}, "
          f"prime off {mb / e2e[False]:.1f}; -c 3 prime on "
          f"{mb / clus['e2e'][True]:.1f}, prime off "
          f"{mb / clus['e2e'][False]:.1f}")
    print("e2e decode MB/s (host decoder): " + "; ".join(
        f"{name} {mb / s:.1f} ({mb / h:.1f})"
        for name, (s, h) in dec["e2e"].items()))
    print("K5 over all columns (the -c 1 primed one in the kernels line): "
          + ", ".join(f"{name} {ms:.3f} ms"
                      for name, ms in dec["all_ms"].items()))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
