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
  1. build the nine kernels (csrc/quantize.cu K1, csrc/coder.cu K2a and
     K2b, csrc/hist.cu K3, csrc/kmeans.cu K4, csrc/decoder.cu K5, and the
     microbenchmark's issue, mix and selmix in csrc/microbench.cu) from
     the sources for sm_90a, one nvcc per source in parallel, with the
     ptxas report
  2. the input; device statistics (K3, one cluster) checked equal to the
     host C++ counts; codebook design
  3. K1 against its plain PyTorch version at the full shape: element-equal
  4. K2a (the triples) and K2b (the chain) each against its plain
     version over all 100 columns of the slice's lane plan, one chunk:
     triples and rescale flags element-equal; words, carry and flags
     equal lane by lane, payload bytes equal; code_lanes equal to the
     two in turn. K2a timed in turns with its plain version, K2b over
     5 runs (its plain version once, tens of seconds); K2b's cycles a
     step; both bounds from their counted SASS (coder_bounds)
  5. the end-to-end encode, -c 1, through
     qvz_tpu_torch.pipeline.encode.encode, timed as the median of 5 runs
     without -u (the phase split is the last run's): the container
     byte-equal to the port's host engine (qvz_tpu_torch.pipeline.host,
     pure C++, held byte-equal to qvz_tpu's by the CPU tests) for the same
     shards, priming and seed; decoded by the host decoder to the
     port's reconstruction; -s figures equal; hist, quantize,
     coder_triples and coder_chain launched by the encode itself
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
  9. K2a and K2b with the cluster-id segment (K2b's first pass) against
     their plain versions over all columns, as in 4
 10. the end-to-end encode, -c 3 -T 4, median of 3 runs without -u, primed
     and unprimed: checked as in 5 against the port's host engine with
     n_clusters=3; hist, kmeans, quantize, coder_triples and coder_chain
     launched by the encode
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
     condition), the decoder launched by the decodes; the first decode's
     peak device memory (torch.cuda.max_memory_allocated), the host RSS
     before and after it and its waves of lanes
 13. 300,000 x 2 at --shards 2, unprimed, whose two lanes reach the
     rescale: flagged, decoded again on the host, byte-equal
 14. K5 over all columns of the four containers at 32, 16, 8, 4, 2 and 1
     lanes a warp: equal output, median of 3 each
 15. the integer-issue microbenchmark (qvz_tpu_torch.microbench, the port
     of scripts/vpu_microbench.py, on no path of the system): every leg
     of the TPU script at reps 6 at its shape, each kernel equal to its
     plain version and the checksum to the script's replay; the mix legs
     at their timed reps equal to the plain version at the TPU's shape,
     the issue legs at reps 4096; each leg timed (median of 5) at the
     TPU's shape and, for the mix legs, with the leading axis scaled to
     fill the shared memory of every SM; per leg the rate by source ops
     and by the SASS instructions of its kernel's inner loop (cuobjdump),
     with the loop's opcode counts and its bound by pipe
 16. 200,000 x 20 at -c BIG_K, the first cluster count whose plan does
     not fit K5's shared-memory layout (K5 stages it at one cluster
     fewer): the encode on the card byte-equal to the host engine and
     decode(device="cuda") byte-equal to the host decoder, K2a and K5
     reading the plan's tables from device memory (layout 1), with hist,
     kmeans, quantize, coder_triples, coder_chain and decoder launched
     by them and no lane coded or decoded on the host; then K2a and K5 in
     each layout that holds the plan, device-memory uses (layout 2)
     included, against their plain versions over all 20 columns

Times are CUDA-event times after a warm-up, kernel and plain version
measured in turns. Each kernel's bound (qvz_tpu_torch.roofline) is the
larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over the card's peak rate: for the
microbenchmark's kernels the slowest pipe for the SASS of their inner
loop; for K2a and K2b the slowest pipe for the least instructions of
each of their loops' trips in their SASS times this run's trips; for K1,
K3, K4 and K5 an estimated count of int32 instructions over the card's
issue rate, SMs x 128 x the top SM clock. A kernel faster than
its bound fails, as does every other check, so the script exits
non-zero. The last two lines are
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


# The lane decoder takes about STEP_OPS int32 instructions a step (the
# model lookup, the count search and update, two products and divisions,
# the renormalisation; csrc/decoder.cu): an estimate, not counted from its
# SASS. K2's bounds are counted from its SASS (coder_bounds).
STEP_OPS = 100
LANES_SWEEP = (32, 16, 8, 4, 2, 1)
# Phase 16's cluster count: at 200,000 x 20 the first K above 149 whose
# plan does not fit K5's shared-memory layout; the phase checks both.
BIG_K = 150


def k5_bound(lanes, cols: int, ops_rate: float):
    """K5 over all columns: the lanes' draws, payloads and cluster ids in,
    the text rows and states out; STEP_OPS a step."""
    from qvz_tpu_torch.roofline import bound
    n = int(sum(lanes.lane_counts))
    nbytes = (n * cols + int(lanes.pays.lens.sum())
              + (n if lanes.cl is not None else 0) + n * (cols + 1)
              + len(lanes.lane_counts) * (4 + 5) * 8)
    return bound(nbytes, n * cols * STEP_OPS, ops_rate)


def _loop(mb, insns, has: str, inside=None, without=None):
    """The smallest loop of `insns` (head, end) with an instruction of
    opcode prefix `has`, none of prefix `without`, nested in `inside`."""
    spans = [(h, e) for h, e in mb.loop_spans(insns).items()
             if (inside is None or inside[0] < h <= e <= inside[1])]
    found = []
    for h, e in spans:
        ops = [i[1] for i in insns if h <= i[0] <= e]
        if any(o.startswith(has) for o in ops) and not (
                without and any(o.startswith(without) for o in ops)):
            found.append((h, e))
    require(bool(found), f"a loop with {has} in the SASS")
    return min(found, key=lambda s: s[1] - s[0])


def coder_bounds(gpu, plan_t, W: int, L: int, n_lines: int, cols: int,
                 live: int, sum_x: int, bytes_a: float, bytes_b: float):
    """K2a's and K2b's bounds from their counted SASS (roofline.pipe_ms):
    each inner loop's least trip by pipe (microbench.trip_min) times its
    trips on this run's data. K2a: the zeroing of the uses, W x the
    16-byte stores a column; the steps, cols x W x L trips, the live ones
    through the count store; the prefix sum, sum_x trips (the symbol
    indices of the live steps). K2b: cols x
    n_lines steps, the live ones through the reciprocal. Returns {name:
    (ms, "bytes" or "operations", pipe, per-pipe instructions)}."""
    import numpy as np
    from qvz_tpu_torch import microbench as mb
    from qvz_tpu_torch.roofline import pipe_ms

    funcs = mb.sass_functions()

    def func(tag):
        names = [k for k in funcs if tag in k]
        require(len(names) == 1, f"one {tag} in the library's SASS")
        return funcs[names[0]]

    def add(total, trips, per):
        for k, v in per.items():
            total[k] = total.get(k, 0) + trips * v

    # K2a's shared-memory layout, the one the main path runs
    a, b = func("triples_kernelILi0E"), func("chain_kernel")
    zero = _loop(mb, a, "STS.128")
    step = _loop(mb, a, "STG.E.64", without="BAR")
    prefix = _loop(mb, a, "LDS.U16", inside=step)
    chain = _loop(mb, b, "MUFU.RCP")
    per_col = (np.ceil(plan_t["col_slots"].cpu().numpy() / 8)
               + np.ceil(np.diff(plan_t["col_model_off"].cpu().numpy()) / 8))
    ta, tb = {}, {}
    add(ta, W * float(per_col.sum()), mb.trip_min(a, zero[0]))
    add(ta, cols * W * L - live, mb.trip_min(a, step[0]))
    add(ta, live, mb.trip_min(a, step[0], "STS.U16"))
    add(ta, sum_x, mb.trip_min(a, prefix[0]))
    add(tb, cols * n_lines - live, mb.trip_min(b, chain[0]))
    add(tb, live, mb.trip_min(b, chain[0], "MUFU.RCP"))
    out = {}
    for name, tot, nbytes in (("coder_triples", ta, bytes_a),
                              ("coder_chain", tb, bytes_b)):
        t = pipe_ms(gpu, tot, 1, nbytes)
        pipe = max(t, key=t.get)
        out[name] = (t[pipe], "bytes" if pipe == "memory" else "operations",
                     pipe, tot)
    return out


def coder_phase(torch, np, plan_t, mid, qs, lane_counts, base, ctrip, gpu,
                tag: str) -> dict:
    """K2a and K2b against their plain versions over all columns, one
    chunk (the segment's chain first where ctrip is given), and K2 through
    code_lanes against both; times, bounds and K2b's cycles a step."""
    from qvz_tpu_torch.ops import coder_device as cd

    dev = mid.device
    cols = mid.shape[0]
    W, L = len(lane_counts), max(lane_counts)
    N = int(sum(lane_counts))
    require(cd.chunk_columns(cols, W, L) == cols,
            f"{tag} all {cols} columns in one chunk")
    mw = -(-(cols + (ctrip is not None)) * L * cd.BITS_PER_STEP_BOUND
           // 32) + 2
    out = {}

    def a_kernel():
        out["a"] = cd.triples(plan_t, mid, qs, lane_counts, base, 0, cols)

    def a_plain():
        out["ap"] = cd.triples_reference(plan_t, mid, qs, lane_counts, base,
                                         0, cols)

    a_ms, a_plain_ms, a_runs, _ = in_turns(a_kernel, a_plain, torch, runs=3)
    (trip, resc), (trip_p, resc_p) = out.pop("a"), out.pop("ap")
    err_a = max_err([trip, resc], [trip_p, resc_p])
    require(err_a == 0 and torch.equal(trip, trip_p)
            and torch.equal(resc, resc_p),
            f"{tag} K2a's triples and rescale flags equal the plain "
            f"version's over all {cols} columns")
    del trip_p

    seg = (cd.segment_triples(ctrip, lane_counts, dev) if ctrip is not None
           else None)

    def start(chain):
        raw = cd.start_raw(W, dev, mw)
        raw[2][5] |= resc.long()
        return chain(seg, 1, lane_counts, raw) if seg is not None else raw

    b_runs = []
    for _ in range(5):
        got = start(cd.chain)
        torch.cuda.synchronize()
        b_runs.append(event_ms(
            lambda: cd.chain(trip, cols, lane_counts, got), torch))
    b_ms = statistics.median(b_runs)
    t = time.perf_counter()
    want = cd.chain_reference(trip, cols, lane_counts,
                              start(cd.chain_reference))
    torch.cuda.synchronize()
    b_plain_ms = (time.perf_counter() - t) * 1e3
    full = cd.code_lanes(plan_t, mid, qs, lane_counts, base, ctrip)
    fetched = [cd.fetch_lanes(*r) for r in (got, want, full)]
    (wk, nk, ck), (wp, np_, cp), (wf, nf, cf) = fetched
    fk = ck[5] != 0
    require(np.array_equal(fk, cp[5] != 0) and np.array_equal(fk, cf[5] != 0),
            f"{tag} K2b's flags equal the plain version's")
    ok = ~fk
    err_b = int(np.abs(ck[:5, ok] - cp[:5, ok]).max(initial=0))
    for w in np.flatnonzero(ok):
        if nk[w]:
            err_b = max(err_b, int(np.abs(wk[w, :nk[w]].astype(np.int64)
                                          - wp[w, :np_[w]].astype(np.int64)
                                          ).max()))
    require(np.array_equal(nk[ok], np_[ok]) and err_b == 0,
            f"{tag} K2b's words and carry equal the plain version's")
    require(np.array_equal(nk, nf) and np.array_equal(ck, cf)
            and all(np.array_equal(wk[w, :nk[w]], wf[w, :nf[w]])
                    for w in range(W)),
            f"{tag} code_lanes equals K2a and K2b in turn")
    pays = cd.payloads_from_raw(wk, nk, ck)[0]
    require(pays == cd.payloads_from_raw(wp, np_, cp)[0],
            f"{tag} K2 payload bytes equal the plain version's")

    m = mid[:, base:base + N]
    live_m = (m > 0) & (plan_t["cards"].long()[m.long()] > 1)
    live = int((trip != 0).sum())
    require(live == int(live_m.sum()) or fk.any(),
            f"{tag} a triple for every live step")
    sum_x = int(qs[:, base:base + N][live_m].sum())
    bounds = coder_bounds(
        gpu, plan_t, W, L, N, cols, live, sum_x,
        8 * cols * N + 8 * cols * L * W,
        8 * cols * N + 4 * int(nk.sum()) + (6 * 8 + 4) * W)
    cycles = b_ms * 1e-3 * gpu.hz / (cols * L)
    print(f"{tag} K2a triples {W} lanes x {cols} columns x {L} lines: "
          f"equal (max abs err {err_a}); kernel {a_ms:.3f} ms ({a_runs}), "
          f"plain {a_plain_ms:.3f} ms (median of 3, in turns); "
          f"{live} live steps, sum of symbol indices {sum_x}; bound "
          f"{bounds['coder_triples'][0]:.4f} ms ({bounds['coder_triples'][1]},"
          f" {bounds['coder_triples'][2]}; SASS instructions by pipe "
          f"{json.dumps(bounds['coder_triples'][3])})", flush=True)
    print(f"{tag} K2b chain {W} lanes x {cols * L} steps"
          f"{' after the cluster-id segment' if seg is not None else ''}: "
          f"equal (max abs err {err_b}), {int(fk.sum())} flagged lanes; "
          f"kernel {b_ms:.3f} ms (median of 5, {b_runs}), plain "
          f"{b_plain_ms:.1f} ms (one run); {cycles:.1f} cycles a step at "
          f"{gpu.hz / 1e6:.0f} MHz; bound {bounds['coder_chain'][0]:.4f} ms "
          f"({bounds['coder_chain'][1]}, {bounds['coder_chain'][2]}; SASS "
          f"instructions by pipe {json.dumps(bounds['coder_chain'][3])}); "
          f"K2a + K2b {a_ms + b_ms:.3f} ms", flush=True)
    # each kernel at each lanes-a-warp setting: equal output, median of 3
    sweep = {}
    for lpw in LANES_SWEEP[:-1]:
        t2 = cd.triples(plan_t, mid, qs, lane_counts, base, 0, cols, lpw)[0]
        require(torch.equal(t2, trip), f"{tag} K2a at {lpw} lanes a warp "
                "equals the default")
        del t2
        a_lpw = statistics.median(event_ms(lambda: cd.triples(
            plan_t, mid, qs, lane_counts, base, 0, cols, lpw), torch)
            for _ in range(3))
        runs = []
        for _ in range(3):
            r = start(cd.chain)
            torch.cuda.synchronize()
            runs.append(event_ms(
                lambda: cd.chain(trip, cols, lane_counts, r, lpw), torch))
        require(torch.equal(r[1], got[1]) and torch.equal(r[2], got[2]),
                f"{tag} K2b at {lpw} lanes a warp equals the default")
        sweep[lpw] = (a_lpw, statistics.median(runs))
    print(f"{tag} K2a, K2b by lanes a warp (defaults {cd.LANES_PER_WARP}, "
          f"{cd.CHAIN_LANES_PER_WARP}; median of 3, equal output): "
          + ", ".join(f"{k}: {a:.3f}, {b:.3f} ms"
                      for k, (a, b) in sweep.items()), flush=True)
    return {"err": max(err_a, err_b), "a_ms": a_ms, "a_plain_ms": a_plain_ms,
            "b_ms": b_ms, "b_plain_ms": b_plain_ms, "bounds": bounds,
            "cycles": cycles}


def proc_status_kb(field: str) -> int:
    """A field of /proc/self/status in kB (VmRSS), 0 if absent."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    return 0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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


def clustered_phases(torch, np, data, dist, gpu, rate) -> dict:
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
    from qvz_tpu_torch.roofline import bound
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
    res["k2"] = coder_phase(torch, np, plan_t, mid, qs, lane_counts, base,
                            ctrip, gpu, "[9]")
    del mid, qs, data_t

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
    for name in ("hist", "kmeans", "quantize", "coder_triples",
                 "coder_chain"):
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
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev_before = torch.cuda.memory_allocated()
        rss_before = proc_status_kb("VmRSS")
        got = port.decode(comp, device="cuda", stats=st)
        mem = (f"device memory {dev_before / 2**20:.1f} MiB allocated before"
               f", peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
               f"(torch.cuda.max_memory_allocated); host RSS "
               f"{rss_before / 1024:.1f} MiB before, "
               f"{proc_status_kb('VmRSS') / 1024:.1f} MiB after")
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
              f" s = {mb / host_secs:.1f} MB/s; {st['waves']} wave(s); "
              f"phases {json.dumps(phases)}; first decode: {mem}",
              flush=True)
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


def big_plan_phase(torch, np, dist) -> None:
    """Phase 16: a plan too large for K5's shared-memory layout. 200,000 x
    20 of the phase-2 generator at -c BIG_K (K5 stages the plan at one
    cluster fewer): the encode and decode(device="cuda") run every lane on
    the card, K2a and K5 reading the plan's tables from device memory;
    then K2a and K5 in each layout that holds the plan against their plain
    versions over all columns."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.constants import MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.ops import quantize as tq
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import decode as pdec
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host

    n, cols, K = 200_000, 20, BIG_K
    dev = torch.device("cuda")
    data = make_input(n, cols, 42)
    fits = {}
    for k in (K - 1, K):
        cl, _, _ = rt.kmeans_host(data, k, 4.0)
        c0, cond = rt.stats_host(data, cl, k)
        tables = rt.Design(c0, cond, MODE_RATIO, 0.5, dist).tables()
        dplan_t = dd.decode_plan_to_torch(
            dd.DecodePlan(cd.LanePlan(tables, None), tables), dev)
        fits[k] = (dd.card_layout(dplan_t, 260), cd.card_layout(dplan_t, 260),
                   dplan_t["S"], dplan_t["models_max"])
    require(fits[K - 1][0] == 0 and fits[K][:2] == (1, 1),
            f"K5 stages the plan at -c {K - 1} and, like K2a, reads its "
            f"tables from device memory at -c {K} (layouts {fits})")

    # -- the main path: every lane on the card ------------------------------
    _build.LAUNCHES.clear()
    t = time.perf_counter()
    out = port.encode(data, dist, n_clusters=K, well_state=WellState.debug(),
                      shards=0, device="cuda")
    enc_secs = time.perf_counter() - t
    st = {}
    t = time.perf_counter()
    got = pdec.decode(out.compressed, device="cuda", stats=st)
    dec_secs = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    ref = host.encode(data, dist, n_clusters=K, well_state=WellState.debug(),
                      shards=port.device_lane_count(n))
    require(out.compressed == ref.compressed,
            f"-c {K}: container byte-equal to the port's host engine")
    require(np.array_equal(got, host.decode(out.compressed)),
            f"-c {K}: decode(device='cuda') byte-equal to the host decoder")
    require(out.stats.coder_fallback_lanes == 0 and st["fallback_lanes"] == 0,
            f"-c {K}: no lane coded or decoded on the host")
    for name in ("hist", "kmeans", "quantize", "coder_triples",
                 "coder_chain", "decoder"):
        require(launches.get(name, 0) >= 1, f"-c {K}: {name} launched")

    # -- each layout that holds the plan against the plain versions --------
    data_t = torch.from_numpy(np.ascontiguousarray(data.T)).to(dev)
    counts, states, offs, _ = port.shard_plan(
        n, cols, port.device_lane_count(n), True, WellState.debug())
    draws_t = torch.from_numpy(host._shard_draws(states, counts, cols)).to(
        dev).t().contiguous()
    mid, qs, _ = tq.quantize_t_device(tq.tables_to_torch(tables, dev), data_t,
                                      draws_t, torch.from_numpy(cl).to(dev))
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, None), dev)
    lane_counts, base = counts[1:], int(offs[1])
    want = cd.triples_reference(plan_t, mid, qs, lane_counts, base, 0, cols)
    a_ms = {}
    for lay in (1, 2):
        def a_run():
            return cd.triples(plan_t, mid, qs, lane_counts, base, 0, cols,
                              layout=lay)

        trip, resc = a_run()
        require(torch.equal(trip, want[0]) and torch.equal(resc, want[1]),
                f"-c {K}: K2a in layout {lay} equals its plain version")
        a_ms[lay] = statistics.median(event_ms(a_run, torch)
                                      for _ in range(3))
    del want, trip, resc, mid, qs, data_t, draws_t

    lanes = pdec.prepare_lanes(out.compressed, "cuda")
    rows = torch.zeros((lanes.draws_t.shape[1], cols + 1), dtype=torch.uint8,
                       device=dev)
    fin = dd.decode_lanes_reference(lanes.dplan_t, lanes.pays, lanes.draws_t,
                                    lanes.cl, lanes.lane_counts, 0,
                                    lanes.starts, rows, 33)
    k5_ms = {}
    for lay in (1, 2):
        o = torch.zeros_like(rows)

        def k5_run():
            return dd.decode_lanes_t(lanes.dplan_t, lanes.pays, lanes.draws_t,
                                     lanes.cl, lanes.lane_counts, 0,
                                     lanes.starts, o, 33, layout=lay)

        f = k5_run()
        require(torch.equal(f, fin) and torch.equal(o, rows),
                f"-c {K}: K5 in layout {lay} equals its plain version")
        k5_ms[lay] = statistics.median(event_ms(k5_run, torch)
                                       for _ in range(3))
    print(f"[16] 200000 x 20 at -c {K} (S = {fits[K][2]}, {fits[K][3]} "
          f"models a column; at -c {K - 1}: S = {fits[K - 1][2]}, "
          f"{fits[K - 1][3]} models; layouts K5, K2a: -c {K - 1} "
          f"{fits[K - 1][:2]}, -c {K} {fits[K][:2]}): encode on the card "
          f"{enc_secs:.3f} s, byte-equal to the host engine; "
          f"decode(device='cuda') {dec_secs:.3f} s, byte-equal to the host "
          f"decoder; {len(lanes.lane_counts)} lanes, 0 coded or decoded on "
          f"the host; launches {launches}; over all {cols} columns, equal "
          f"to the plain versions: K2a layout 1 {a_ms[1]:.3f} ms, layout 2 "
          f"{a_ms[2]:.3f} ms; K5 layout 1 {k5_ms[1]:.3f} ms, layout 2 "
          f"{k5_ms[2]:.3f} ms (median of 3)", flush=True)


def microbench_phase() -> list:
    """Phase 15: the microbenchmark's legs (qvz_tpu_torch.microbench);
    returns its three kernels' entries of the kernels line."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch import microbench as mb

    _build.LAUNCHES.clear()
    t = time.perf_counter()
    res = mb.run_legs("cuda", prefix="[15] ")
    launches = dict(_build.LAUNCHES)
    entries = []
    for name in ("issue", "mix", "selmix"):
        e = dict(res["kernels"][name], launches=launches.get(name, 0))
        require(e["launches"] >= 1, f"phase 15 launched {name}")
        require(e["max_abs_err"] == 0, f"{name} equals its plain version")
        entries.append(e)
    print(f"[15] microbenchmark: {len(res['legs'])} legs in "
          f"{time.perf_counter() - t:.1f} s, every kernel equal to its plain "
          f"version and every checksum to the replay; launches {launches}",
          flush=True)
    return entries


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
    from qvz_tpu_torch.roofline import (ALU_LANES_PER_SM, FMA_LANES_PER_SM,
                                        HBM_BYTES_PER_S, SHARED_WORDS_PER_SM,
                                        bound)
    from qvz_tpu_torch.roofline import card as read_card

    dev = torch.device("cuda")
    gpu = read_card(dev)
    card = gpu.name
    rate = gpu.int32_per_s

    # -- 0. the card ------------------------------------------------------
    print(f"[0] card: {card}")
    print(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"devices {torch.cuda.device_count()}")
    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    print(f"[0] nvcc: {nv[-1] if nv else '?'}", flush=True)
    print(f"[0] bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s device memory; "
          f"{rate / 1e12:.2f} T int32 instructions/s issued ({gpu.sms} SMs x "
          f"128 x {gpu.hz / 1e6:.0f} MHz); by pipe, per s: "
          f"{gpu.per_s(ALU_LANES_PER_SM) / 1e12:.2f} T ALU, "
          f"{gpu.per_s(FMA_LANES_PER_SM) / 1e12:.2f} T IMAD, "
          f"{gpu.per_s(SHARED_WORDS_PER_SM) / 1e12:.2f} T shared words",
          flush=True)

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

    # -- 4. K2a and K2b against their plain versions -------------------------
    w_n = int(counts[0])
    md0, qs0, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data[:w_n].T), None, states[0])
    bank = rt.bank_from_stream(tables, md0, qs0, None, w_n)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, bank), dev)
    k2 = coder_phase(torch, np, plan_t, mid, qs, counts[1:], int(offs[1]),
                     None, gpu, "[4]")
    del mid, qs, got, data_t, draws_t

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
    for name in ("hist", "quantize", "coder_triples", "coder_chain"):
        require(launches.get(name, 0) >= 1, f"the encode launched {name}")

    # -- 6.-10. the clustered path (-c 3 -T 4) -----------------------------
    clus = clustered_phases(torch, np, data, dist, gpu, rate)
    for name, k in clus["launches"].items():
        launches[name] = launches.get(name, 0) + k
    containers.update(clus.pop("containers"))

    # -- 11.-13. the device decode -------------------------------------------
    dec = decode_phases(torch, np, containers, dist, rate)
    launches["decoder"] = dec["launches"]["decoder"]

    # -- 15. the integer-issue microbenchmark --------------------------------
    mb_kernels = microbench_phase()

    # -- 16. a plan too large for K5's shared-memory layout -----------------
    big_plan_phase(torch, np, dist)
    require("jax" not in sys.modules, "no JAX imported")

    kernels = [
        {"name": "quantize", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/quantize.cu",
         "replaces": "qvz_tpu/ops/quantize_pallas.py:292",
         "launches": launches["quantize"],
         "max_abs_err": max(k1_err, clus["k1_err"]),
         "ms": k1, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        *({"name": name, "route": "cuda",
           "source": "qvz_tpu_torch/csrc/coder.cu",
           "replaces": "qvz_tpu/ops/coder_pallas.py:159",
           "launches": launches[name],
           "max_abs_err": max(k2["err"], clus["k2"]["err"]),
           "ms": k2[f"{p}_ms"], "plain_ms": k2[f"{p}_plain_ms"],
           "bound_ms": k2["bounds"][name][0],
           "bound_by": k2["bounds"][name][1], "library_ms": None}
          for name, p in (("coder_triples", "a"), ("coder_chain", "b"))),
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
        *mb_kernels,
    ]
    for k in kernels:
        require(k["ms"] >= k["bound_ms"],
                f"{k['name']} ({k['ms']} ms) no faster than its bound")
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
