#!/usr/bin/env python3
"""Quickest proof that qvz_tpu_torch runs on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Drives the port's main paths, the device QVZ2 encode with one cluster
and with k-means clustering (-c 3 -T 4) and the device decode of their
containers, the streamed encode of an input above 1 GiB (phase 17) and
the multi-host encode and decode (phase 18), at a full-size input: 1,000,000 reads x 100 columns of
Illumina-like quality scores made from seed 42, -f 0.5, MSE, --shards 0
(the device lane count), priming on and off, the debug WELL seed.
Phases:

  0. the card (nvidia-smi name and power limit), torch, CUDA and nvcc
  1. build the twelve kernels (csrc/quantize.cu K1, csrc/coder.cu K2a,
     K2b and K2s, csrc/hist.cu K3, csrc/kmeans.cu K4, csrc/decoder.cu K5
     and K5p, csrc/well.cu KW, and the microbenchmark's issue, mix and
     selmix in csrc/microbench.cu) from
     the sources for sm_90a, one nvcc per source in parallel, with the
     ptxas report
  2. the input; device statistics (K3, one cluster) checked equal to the
     host C++ counts; codebook design
  3. K1 against its plain PyTorch version at the full shape: element-equal,
     timed in turns with it; its bound from its counted SASS (k1_bound)
  4. K2a (the triples) and K2b (the chain) each against its plain
     version over all 100 columns of the slice's lane plan, one chunk,
     with its count of models at risk (coder_device.risk_tables; none
     at 1M x 100, so K2a runs without records): triples element-equal;
     words and carry equal lane by lane, no lane overrun, payload bytes
     equal; code_lanes equal to the two in turn. K2a timed in turns with
     its plain version, K2b over 5 runs (its plain version once, tens of
     seconds); K2b's cycles a step; both bounds from their counted SASS
     (coder_bounds, the templates without records)
  5. the end-to-end encode, -c 1, through
     qvz_tpu_torch.pipeline.encode.encode, timed as the median of 5 runs
     without -u (the phase split is the last run's): the container
     byte-equal to the port's host engine (qvz_tpu_torch.pipeline.host,
     pure C++, held byte-equal to qvz_tpu's by the CPU tests) for the same
     shards, priming and seed; decoded by the host decoder to the
     port's reconstruction; -s figures equal; hist, quantize,
     coder_triples and coder_chain launched by the encode itself; the
     encode's stats phase split into K3 (CUDA events) and the counts'
     copy to the host
  6. K4, one k-means step at K = 3 from seed_centroids, against its plain
     version (assign, sums and counts equal), also with two identical
     means (every tie to the lower index), timed in turns with it, its
     bound from its counted SASS (k4_bound); at six small and odd
     shapes (16-read tiles, the 1,022-column ceiling, each of the three
     places the sums gather) against its plain version; then
     kmeans_cluster on the
     card against the host C++ rt.kmeans_host: equal assignment, means
     and iteration count
  7. K3 against its plain version and rt.stats_host at C = 1 and with
     the k-means ids of phase 6 (C = 3), on the input and on its copy
     binned to the four Phred values of a NovaSeq (2, 12, 23, 37), each
     timed in turns with the plain version; its bound from its counted
     SASS (k3_bound), and the outputs' zeroing (two torch.zeros in the
     call, not K3) timed apart; at ten odd shapes (one read, one and two
     columns, ragged N, C = 11 and 12 on each side of the shared-memory
     layout, C = 255, ids at or past C in each mode, which K3 does not
     count) against its plain version over the reads it counts;
     torch.bincount over the combined (column, cluster*72 + previous,
     current) index at C = 1 and 3, timed as K3's library yardstick (the
     port never calls it)
  8. K1 with the k-means ids against its plain version at the full shape,
     as in 3
  9. K2s, the cluster-id segment's triples from the k-means ids on the
     card, against its plain version and the host's rt.replay_model on
     every lane, timed in turns with the plain version, its bound from its
     counted SASS (k2s_bound); K2a and K2b with the segment (K2b's first
     pass) against their plain versions over all columns, as in 4
 10. the end-to-end encode, -c 3 -T 4, median of 3 runs without -u, primed
     and unprimed: checked as in 5 against the port's host engine with
     n_clusters=3; hist, kmeans, quantize, coder_triples and coder_chain
     launched by the encode, and coder_segment (K2s)
 11. K5 against its plain version on the lanes of the four containers of
     phases 5 and 10: on the first 2 columns of every lane the rows, the
     final (l, u, t, bit position) and the flags equal, and over all
     columns for the -c 1 primed container (the plain loop takes tens of
     seconds there); the kernel timed over all columns; the -c 3 lanes
     start mid-byte after their cluster-id prologue; each container's
     count of models at risk
 12. K5p on the lanes of each of those containers against its plain
     version and, lane by lane, the host's rt.decode_cluster_prologue
     (the -c 3 ids and states, the -c 1 starts), timed in turns with the
     plain version, its bound from its counted SASS at -c 3 primed
     (k5p_bound); then the end-to-end decode of those containers through
     qvz_tpu_torch.pipeline.decode.decode(device="cuda"), median of 3
     runs beside the port's host decoder in the same call: byte-equal to
     it and to the encode's -u reconstruction + 33, no lane flagged (only
     a corrupt lane is), the decoder and cluster_prologue (K5p) launched
     by the decodes, the prologue phase printed beside the decode's time;
     the first decode's peak device memory (torch.cuda.max_memory_allocated), the host RSS
     before and after it and its waves of lanes
 13. the rescale on the card: 300,000 x 2 at --shards 2, unprimed, whose
     two lanes' models pass 2^19 (qvz_tpu flags both): the in-memory
     encode on the card byte-equal to the host engine with
     coder_fallback_lanes 0, and decode(device="cuda") byte-equal to the
     host decoder with 0 lanes flagged, K2a, K2b and K5 launched; then
     rescale_case: a -c 3 plan of 16 lanes of 36,000 reads whose lanes
     rescale (a column model and the cluster-id model twice in a lane),
     K2a and K5 in each of layouts 0, 1 and 2, forced, and K2b, K2s and
     K5p against their plain versions on the CPU, K2s and K5p also
     against the host's replay and prologue, every payload the host
     coder's and every decode the host decoder's, each kernel timed
     (median of 3); and pending_runs: K2b at pending
     runs of 31 to 100 bits against its plain version and a bit
     writer
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
     kmeans, quantize, coder_segment, coder_triples, coder_chain,
     cluster_prologue and decoder launched by them and no lane coded or
     decoded on the host; K2s and K5p against their plain versions and
     the host's replay and prologue, as in 9 and 12; then K4 at K =
     BIG_K against its plain version (median of 3) and kmeans_cluster at
     K = BIG_K on the card against rt.kmeans_host, as in 6; K3 at C =
     BIG_K (its counters in device memory) against its plain version and
     rt.stats_host, timed in turns with the plain version, its bound
     from its counted SASS; K1 against
     its plain version, as in 3; K2a and K5 in each layout that holds the
     plan, device-memory uses (layout 2) included, against their plain
     versions over all 20 columns
 17. a streamed encode of more than 1 GiB: 11,000,000 x 100 reads (1.111
     GB, 1,000,000-read blocks of the phase-2 generator, seeds 42-52)
     written under build/, and three child interpreters running
     qvz_tpu_torch.cli.main: A, -f 0.5 --debug-seed --shards 512 -s, which
     streams by itself (pipeline/streaming.py: K3 a chunk, K1 a shard, the
     coding on host threads); B, the same with -u and
     QVZ_TPU_STREAM_MIN_BYTES above the file's size, the in-memory device
     encode; C, -x of A's container on the card. Each child's encode and
     decode are wrapped (STREAM_CHILD) to read B's coder_fallback_lanes
     and host re-coding and C's fallback_lanes and phases: 0 lanes sent
     to the host by either; the plan's models at risk and the bytes of
     K2a's and K5's records (stream_risk). A's container equals
     B's, its -s rate, distortion and size B's, C's text B's -u file; A
     launched hist 11 times and quantize once a shard; A's peak RSS
     (ru_maxrss) is below B's by the input's size at least and its peak
     device memory (torch.cuda.max_memory_allocated) below B's; each
     child's seconds, MB/s and peaks printed; the directory is removed
     after
 18. multi-host on the card: phase 2's input written to a file;
     encode_multihost at 2 hosts and the device lane count with
     device="cuda", byte-equal to phase 5's primed container, each
     in-memory worker launching K3 once; the CLI's --hosts 2 --streaming
     -c 3 -T 4 at that shard count, byte-equal to phase 10's primed
     container; decode_multihost at 2 hosts of phase 5's container,
     byte-equal to the host decoder
 19. the multi-device encode (pipeline.encode.encode(mesh=...),
     parallel/sharded.py) with several blocks of reads on the one card:
     -c 3 -T 4 primed at phase 10's shard count over
     make_mesh(devices=["cuda:0"] * 4), byte-equal to phase 10's primed
     container, and -c 1 primed at --shards 0 over 2 blocks, byte-equal to
     phase 5's; K4 (each step), K3, K1, K2a + K2b and, at -c 3, K2s
     launched for every block, counted call by call; the -c 3 container
     decoded on the card (K5p, K5) to the host decoder's bytes; each encode's time and phase split
     beside the one-device median. A check of correctness on one card,
     not a multi-GPU measurement
 20. torch.distributed (parallel/distributed.py): two child interpreters
     over Gloo, each with half of phase 2's reads and phase 6's k-means
     ids, K3 on the card and one all-reduce: both get phase 8's counts
     (C = 3) and design identical codebook blocks (sha256 printed), each
     on the card that initialize picks for it; then world size 1 over
     NCCL in this process, equal to the same counts
 21. the tools (host only, no kernel): transcode of phase 5's primed
     container to v1, byte-equal to the port's --shards 1 encode of the
     input, and back to QVZ2 at the device lane count, byte-equal to
     phase 5's container; python -m qvz_tpu_torch.tools.mse_check of the
     decoded text against phase 5's -u reconstruction (distortion 0) and
     of the input against it (phase 5's -s distortion)
 22. scripts/sanitize_torch.py's workload in a child interpreter
     (--child none), the kernels from their line-info build: every kernel
     of csrc/ in each of its code paths (K1 at -c 1 and -c 3; K2a in
     layouts 0-2, without and with the records of models that rescale;
     K2b with the cluster-id segment, through rescales and at pending
     runs of 31-100 bits; K2s at -c 3 and through model 0's rescales;
     K3 modes 0 and 1; K4's three sums modes, three tiles a block or
     more; K5 and its text-row kernel in layouts 0-2, primed and
     unprimed, and with records; K5p at -c 1 and -c 3, through model 0's
     rescales and on lanes it flags; issue, mix and selmix) equal to its
     plain version on the CPU, then the corrupt-container corpus (52
     column-major QVZ2 containers of 20,000 x 50 with lanes) decoded with
     device="cuda" to the host decoder's outcome, K5p and K5 launched for
     each container whose host stages pass, K5p there equal to the
     host's prologue lane by lane. The script's
     compute-sanitizer runs (memcheck, racecheck, synccheck, initcheck)
     are not part of this phase: the tool refuses a card inside a gVisor
     sandbox ("Device not supported"), and there the script raises
 23. KW, the encode's WELL dither draws, on the plan of a 10,000,000 x
     100 file at --shards 0, primed, the debug seed (8,171 shards: 8,170
     lanes of 1,216 reads after a 65,536-read warmup shard), in the
     streams the encode gives it (ops/well_draws.stream_plan: the warmup
     shard in lane-sized pieces): its (100, N) draws equal the host's
     rt.well_draws7 on every shard (pipeline.host._shard_draws) and its
     plain version's on the card; KW timed (median of 5) and its device
     time (torch.profiler, the mean of 5 launches), also on the shards
     uncut (the warmup shard one stream); the plain version timed once;
     the pieces' jump-ahead timed on the host; its bound from its bytes
     (the draws written, the states and offsets read) and the step's
     integer operations. Then KJ, the streams' start states on the card
     from their word offsets (ops/well_jump.states_t): equal to the host
     chain's (rt.well_jump, as stream_plan gives them) on every stream and
     to its plain version's on the card; timed (median of 6, the
     offsets' upload included), its device time (profiler, mean of 5),
     the plain version once and the host chain (shard_plan and
     stream_plan) once; its bound from its operations (a three-input
     AND-XOR a word of each row and a parity a row, for every set bit of
     every offset) and its bytes (the table's matrices it reads, the
     offsets and the states)

Times are CUDA-event times after a warm-up, kernel and plain version
measured in turns, one call each. Each kernel's bound
(qvz_tpu_torch.roofline) is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its operations over
the card's peak rate: for the microbenchmark's kernels the slowest pipe
for the SASS of their inner loop; for K1, K2a, K2b, K2s, K3, K4, K5 and
K5p the slowest pipe for the least instructions of each of their loops'
trips in their SASS times this run's trips (K5's serial steps and count
search; k5_bound). A kernel faster than its bound fails, as does every other check, so the
script exits non-zero. The last two lines are the kernels' JSON record
and the result line {"ok": true, "device": {...}}. Without a CUDA
device, or without the rest of the repository, the script fails before
it prints any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


LANES_SWEEP = (32, 16, 8, 4, 2, 1)
# Phase 16's cluster count: at 200,000 x 20 the first K above 149 whose
# plan does not fit K5's shared-memory layout; the phase checks both.
BIG_K = 150


def k5_bound(gpu, lanes, cols: int, live: int, sum_x: int):
    """K5's bound from its counted SASS (the layout the main path runs,
    decode_lanes_kernel<0, false>, without records): each loop's least
    trip by pipe (microbench.trip_min) times its trips on this run's
    data, the same lanes and steps as K2's (coder_phase's live steps and
    the sum of their symbol indices). The serial steps, cols x n_lines
    trips, the live ones through the reciprocal; the count search, sum_x
    trips. The chunks' model resolution and output loops and the column
    staging are not counted, so the bound is lower than the work. Bytes:
    the lanes' draws, payloads and cluster ids in, the text rows and the
    lanes' states out."""
    from qvz_tpu_torch import microbench as mb
    f = _sass("decode_lanes_kernelILi0ELb0E")
    step = _loop(mb, f, "MUFU.RCP64H")
    search = _loop(mb, f, "LDS.U16", inside=step)
    for (h, e), op in ((step, "MUFU.RCP64H"), (search, "LDS.U16")):
        nested = [(a, b) for a, b in mb.loop_spans(f).items()
                  if h < a and b <= e]
        ones = [i for i in f if h <= i[0] <= e and i[1].startswith(op)
                and not any(a <= i[0] <= b for a, b in nested)]
        require(len(ones) == 1, f"K5's loop at {h:#x} holds one {op} (not "
                f"unrolled): {len(ones)}")
    n = int(sum(lanes.lane_counts))
    nbytes = (n * cols + int(lanes.pays.lens.sum())
              + (n if lanes.cl is not None else 0) + n * (cols + 1)
              + len(lanes.lane_counts) * (4 + 5) * 8)
    return _pipe_bound(gpu, [
        (cols * n - live, mb.trip_min(f, step[0])),
        (live, mb.trip_min(f, step[0], "MUFU.RCP64H")),
        (sum_x, mb.trip_min(f, search[0]))], nbytes)


def _loop(mb, insns, has: str, inside=None, without=None, outside=None):
    """The smallest loop of `insns` (head, end) with an instruction of
    opcode `has` (a prefix; a whole opcode where it ends with "$"), none of
    prefix `without`, nested in `inside` and not in `outside`."""
    spans = [(h, e) for h, e in mb.loop_spans(insns).items()
             if (inside is None or inside[0] < h <= e <= inside[1])
             and (outside is None or not outside[0] <= h <= outside[1])]

    def match(o):
        return o == has[:-1] if has.endswith("$") else o.startswith(has)

    found = []
    for h, e in spans:
        ops = [i[1] for i in insns if h <= i[0] <= e]
        if any(match(o) for o in ops) and not (
                without and any(o.startswith(without) for o in ops)):
            found.append((h, e))
    require(bool(found), f"a loop with {has} in the SASS")
    return min(found, key=lambda s: s[1] - s[0])


def _sass(tag: str):
    """The SASS of the one function of the kernel library named with
    `tag`."""
    from qvz_tpu_torch import microbench as mb
    funcs = mb.sass_functions()
    names = [k for k in funcs if tag in k]
    require(len(names) == 1, f"one {tag} in the library's SASS")
    return funcs[names[0]]


def _pipe_bound(gpu, parts, nbytes: float):
    """(ms, "bytes" or "operations", pipe, per-pipe instructions) of
    `parts`, (trips, least trip by pipe) each, and `nbytes`."""
    from qvz_tpu_torch.roofline import pipe_ms
    tot = {}
    for trips, per in parts:
        for key, v in per.items():
            tot[key] = tot.get(key, 0) + trips * v
    t = pipe_ms(gpu, tot, 1, nbytes)
    pipe = max(t, key=t.get)
    return t[pipe], "bytes" if pipe == "memory" else "operations", pipe, tot


def k4_bound(gpu, shape: dict, n: int, cols: int, k: int):
    """K4's bound from its counted SASS (the kernel of this shape's kt and
    mode): each loop's least trip (microbench.trip_min) times this run's
    trips. The staging, a 16-byte copy a trip: cols x T / 16 a tile; the
    distances, 4 columns of 4 reads against kt means a trip: T / 4 x
    ceil(k / kt) x ceil(cols / 4) a tile; the sums, 16 bytes of a column
    a trip: cols x T / 16 a tile. Bytes: the reads, the assignments, the
    packed means, the sums and the counts."""
    from qvz_tpu_torch import microbench as mb
    f = _sass(f"kmeans_kernelILi{shape['kt']}ELi{shape['mode']}E")
    T, tiles, kt = shape["T"], shape["tiles"], shape["kt"]
    g4 = -(-cols // 4)
    stage = _loop(mb, f, "LDGSTS.E.BYPASS.128")
    dist = _loop(mb, f, "VABSDIFF4")
    sums = (_loop(mb, f, "IDP", without="PRMT") if shape["mode"] == 0
            else _loop(mb, f, "ATOM"))
    nbytes = n * cols + 4 * n + 4 * g4 * shape["k_pad"] + 8 * k * (cols + 1)
    return _pipe_bound(gpu, [
        (tiles * cols * T // 16, mb.trip_min(f, stage[0])),
        (tiles * T // 4 * -(-k // kt) * g4, mb.trip_min(f, dist[0])),
        (tiles * cols * T // 16, mb.trip_min(f, sums[0]))], nbytes)


def k3_bound(gpu, shape: dict, n: int, cols: int, c: int):
    """K3's bound from its counted SASS (the kernel of this shape's
    mode): each loop's least trip (microbench.trip_min) times this
    run's trips, a shared atomic one shared word. Mode 0 zeroes and then
    flushes its shared counters, a 16-byte word a trip: (nbands x C x 72
    + pairs x C x 5,184) / 4 a slice; the rounds, a group of 16 reads a
    thread, and within them the column loop, one pair of the band a trip
    through its increments: the rounds' thread-trips x nbands and x
    pairs. Bytes: each column once, the ids once, the counts written once
    (their zeroing, two torch.zeros of their own in the call, is timed
    apart in phase 7)."""
    from qvz_tpu_torch import microbench as mb
    from qvz_tpu_torch.ops import stats as ts

    f = _sass(f"hist_kernelILb{shape['mode']}EE")
    pairs = cols - 1
    thr, step = shape["threads"], ts.GROUP * shape["threads"]
    rounds = sum(-(-min(shape["slice"], n - s * shape["slice"]) // step)
                 for s in range(shape["nslices"])) * thr
    inc = "ATOMS" if shape["mode"] == 0 else "REDG"
    cols_loop = _loop(mb, f, inc)
    outer = min(((h, e) for h, e in mb.loop_spans(f).items()
                 if h < cols_loop[0] and cols_loop[1] <= e),
                key=lambda s: s[1] - s[0])
    parts = [(rounds * shape["nbands"], mb.trip_min(f, outer[0])),
             (rounds * pairs, mb.trip_min(f, cols_loop[0], inc))]
    if shape["mode"] == 0:
        words4 = shape["nslices"] * (shape["nbands"] * c * 72
                                     + pairs * c * ts.BINS) // 4
        parts += [(words4, mb.trip_min(f, _loop(mb, f, "STS.128")[0])),
                  (words4, mb.trip_min(f, _loop(mb, f, "LDS.128")[0]))]
    out = 8 * (c * 72 + c * pairs * ts.BINS)
    return _pipe_bound(gpu, parts, n * cols + (n if c > 1 else 0) + out)


def k1_bound(gpu, tabs: dict, n: int, cols: int, clustered: bool):
    """K1's bound from its counted SASS: each loop's least trip times this
    run's trips. The column loop, a thread's reads in one column a trip,
    through the 16-byte stores for the threads whose reads all lie below
    n: blocks x THREADS x cols; the inputs' staging, a 16-byte copy a
    trip: 2 x the block's reads / 16 a block and column. Bytes: data and
    draws in, mid, qs and qv out, the cluster ids, and ctx2, pair_bounds
    and qsv."""
    from qvz_tpu_torch import microbench as mb
    from qvz_tpu_torch.ops import quantize as tq

    f = _sass("quantize_kernel")
    per_block = tq.BLOCK_READS
    blocks = -(-n // per_block)
    col = _loop(mb, f, "BAR")
    full = n // tq.READS if n % 4 == 0 else 0
    inputs = _loop(mb, f, "LDGSTS.E.BYPASS.128", inside=col)
    parts = [(full * cols, mb.trip_min(f, col[0], "STG.E.128")),
             ((blocks * tq.THREADS - full) * cols, mb.trip_min(f, col[0])),
             (blocks * cols * 2 * per_block // 16,
              mb.trip_min(f, inputs[0]))]
    nbytes = (14 * n * cols + (n if clustered else 0)
              + sum(int(tabs[key].numel() * tabs[key].element_size())
                    for key in ("ctx2", "pair_bounds", "qsv")))
    return _pipe_bound(gpu, parts, nbytes)


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

    # K2a's shared-memory layout without records, the one the main path
    # runs
    a, b = func("triples_kernelILi0ELb0E"), func("chain_kernel")
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


def coder_phase(torch, np, plan_t, mid, qs, lane_counts, base, clusters,
                gpu, tag: str) -> dict:
    """K2a and K2b against their plain versions over all columns, one
    chunk (the segment's chain first where the lines' cluster ids
    `clusters` are given, its triples from K2s), and K2 through code_lanes
    against both; times, bounds and K2b's cycles a step."""
    from qvz_tpu_torch.ops import coder_device as cd

    dev = mid.device
    cols = mid.shape[0]
    W, L = len(lane_counts), max(lane_counts)
    N = int(sum(lane_counts))
    require(cd.chunk_columns(cols, W, L) == cols,
            f"{tag} all {cols} columns in one chunk")
    mw = -(-(cols + (clusters is not None)) * L * cd.BITS_PER_STEP_BOUND
           // 32) + 2
    out = {}

    def a_kernel():
        out["a"] = cd.triples(plan_t, mid, qs, lane_counts, base, 0, cols)

    def a_plain():
        out["ap"] = cd.triples_reference(plan_t, mid, qs, lane_counts, base,
                                         0, cols)

    a_ms, a_plain_ms, a_runs, _ = in_turns(a_kernel, a_plain, torch, runs=3)
    trip, trip_p = out.pop("a"), out.pop("ap")
    err_a = max_err([trip], [trip_p])
    require(err_a == 0 and torch.equal(trip, trip_p),
            f"{tag} K2a's triples equal the plain version's over all "
            f"{cols} columns")
    del trip_p
    risk = cd.risk_tables(plan_t, L)

    seg = (cd.segment_triples(plan_t, clusters, lane_counts, base)
           if clusters is not None else None)

    def start(chain):
        raw = cd.start_raw(W, dev, mw)
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
    full = cd.code_lanes(plan_t, mid, qs, lane_counts, base, clusters)
    fetched = [cd.fetch_lanes(*r) for r in (got, want, full)]
    (wk, nk, ck), (wp, np_, cp), (wf, nf, cf) = fetched
    require(not (ck[5] != 0).any() and not (cf[5] != 0).any(),
            f"{tag} K2b ran past no lane's words")
    err_b = int(np.abs(ck - cp).max(initial=0))
    for w in range(W):
        if nk[w]:
            err_b = max(err_b, int(np.abs(wk[w, :nk[w]].astype(np.int64)
                                          - wp[w, :np_[w]].astype(np.int64)
                                          ).max()))
    require(np.array_equal(nk, np_) and err_b == 0,
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
    require(live == int(live_m.sum()), f"{tag} a triple for every live step")
    sum_x = int(qs[:, base:base + N][live_m].sum())
    bounds = coder_bounds(
        gpu, plan_t, W, L, N, cols, live, sum_x,
        8 * cols * N + 8 * cols * L * W,
        8 * cols * N + 4 * int(nk.sum()) + (6 * 8 + 4) * W)
    cycles = b_ms * 1e-3 * gpu.hz / (cols * L)
    print(f"{tag} K2a triples {W} lanes x {cols} columns x {L} lines, "
          f"{risk['models']} models at risk (records "
          f"{8 * W * int(risk['roff_h'][-1])} B): "
          f"equal (max abs err {err_a}); kernel {a_ms:.3f} ms ({a_runs}), "
          f"plain {a_plain_ms:.3f} ms (median of 3, in turns); "
          f"{live} live steps, sum of symbol indices {sum_x}; bound "
          f"{bounds['coder_triples'][0]:.4f} ms ({bounds['coder_triples'][1]},"
          f" {bounds['coder_triples'][2]}; SASS instructions by pipe "
          f"{json.dumps(bounds['coder_triples'][3])})", flush=True)
    print(f"{tag} K2b chain {W} lanes x {cols * L} steps"
          f"{' after the cluster-id segment' if seg is not None else ''}: "
          f"equal (max abs err {err_b}), 0 lanes flagged; "
          f"kernel {b_ms:.3f} ms (median of 5, {b_runs}), plain "
          f"{b_plain_ms:.1f} ms (one run); {cycles:.1f} cycles a step at "
          f"{gpu.hz / 1e6:.0f} MHz; bound {bounds['coder_chain'][0]:.4f} ms "
          f"({bounds['coder_chain'][1]}, {bounds['coder_chain'][2]}; SASS "
          f"instructions by pipe {json.dumps(bounds['coder_chain'][3])}); "
          f"K2a + K2b {a_ms + b_ms:.3f} ms", flush=True)
    # each kernel at each lanes-a-warp setting: equal output, median of 3
    sweep = {}
    for lpw in LANES_SWEEP[:-1]:
        t2 = cd.triples(plan_t, mid, qs, lane_counts, base, 0, cols, lpw)
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
            "cycles": cycles, "live": live, "sum_x": sum_x}


def k2s_bound(gpu, W: int, L: int, n: int, sum_x: int, rescales: int,
              card: int):
    """K2s's bound from its counted SASS (segment_kernel): each loop's least
    trip by pipe times its trips on this run's data. The steps, W x L
    trips (every lane runs to the longest lane's end, writing 0 past its
    own), the n live ones through the count store; the prefix sum, sum_x
    trips (the ids); the halving, card trips a rescale of model 0; the
    counts' load, card a lane. Bytes: the ids and the lane offsets in,
    the triples out."""
    from qvz_tpu_torch import microbench as mb
    f = _sass("segment_kernel")
    step = _loop(mb, f, "STG.E.64")
    prefix = _loop(mb, f, "LDS", inside=step, without="STS")
    halve = _loop(mb, f, "STS", inside=step)
    load = _loop(mb, f, "LDG", outside=step)
    nbytes = n + 8 * (W + 1) + 4 * card + 8 * L * W
    return _pipe_bound(gpu, [
        (W * L - n, mb.trip_min(f, step[0])),
        (n, mb.trip_min(f, step[0], "STS")),
        (sum_x, mb.trip_min(f, prefix[0])),
        (rescales * card, mb.trip_min(f, halve[0])),
        (W * card, mb.trip_min(f, load[0]))], nbytes)


def k5p_bound(gpu, W: int, n: int, sum_x: int, rescales: int, card: int,
              pay_bytes: int):
    """K5p's bound from its counted SASS (cluster_prologue_kernel): each
    loop's least trip by pipe times its trips on this run's data. The
    steps, n (the lanes' lines where card > 1), each through the
    reciprocal; the count search, sum_x trips (the ids); the halving, card
    trips a rescale of model 0; the counts' load, card a lane. Bytes: the
    payload bytes the prologues consume and the lanes' offsets in, the ids,
    states and flags out."""
    from qvz_tpu_torch import microbench as mb
    f = _sass("cluster_prologue_kernel")
    step = _loop(mb, f, "MUFU.RCP64H")
    search = _loop(mb, f, "LDS", inside=step, without="STS")
    halve = _loop(mb, f, "STS", inside=step)
    load = _loop(mb, f, "LDG", outside=step)
    nbytes = pay_bytes + 8 * (W + 1) + 16 * W + 4 * card + n + 40 * W
    return _pipe_bound(gpu, [
        (n, mb.trip_min(f, step[0], "MUFU.RCP64H")),
        (sum_x, mb.trip_min(f, search[0])),
        (rescales * card, mb.trip_min(f, halve[0])),
        (W * card, mb.trip_min(f, load[0]))], nbytes)


def _model0_replay(np, init_counts, init_total, ids, lane_counts, base):
    """The host's replay of the cluster-id model from init_counts and
    init_total over each lane's ids (rt.replay_model): the packed (L, W)
    triples, the sum of the ids and model 0's rescales."""
    from qvz_tpu_torch.native import runtime as rt
    W, L = len(lane_counts), max(lane_counts)
    trip = np.zeros((L, W), dtype=np.int64)
    rescales = 0
    lo = base
    for w, cnt in enumerate(lane_counts):
        h = rt.replay_model(init_counts, init_total,
                            ids[lo:lo + cnt]).astype(np.int64)
        trip[:cnt, w] = h[:, 0] | (h[:, 1] << 20) | (h[:, 2] << 40)
        rescales += int((h[:, 2] + 8 > 1 << 19).sum())
        lo += cnt
    return trip, int(ids[base:lo].astype(np.int64).sum()), rescales


def segment_phase(torch, np, plan, plan_t, cl_t, ids, lane_counts, base,
                  gpu, tag: str) -> dict:
    """K2s against its plain version (on the card's tensors) and the host's
    rt.replay_model on every lane of a -c K plan: the triples equal; K2s
    timed in turns with its plain version; its bound from its counted SASS
    (k2s_bound). ids: the lines' cluster ids on the host."""
    from qvz_tpu_torch.ops import coder_device as cd

    out = {}

    def kernel():
        out["k"] = cd.segment_triples(plan_t, cl_t, lane_counts, base)

    def plain():
        out["p"] = cd.segment_triples_reference(plan_t, cl_t, lane_counts,
                                                base)

    ms, plain_ms, runs, _ = in_turns(kernel, plain, torch, runs=3)
    got, want = out["k"], out["p"]
    err = max_err([got], [want])
    require(err == 0 and torch.equal(got, want),
            f"{tag} K2s's triples equal its plain version's")
    host_trip, sum_x, rescales = _model0_replay(
        np, plan.cluster_init_counts, plan.cluster_init_total, ids,
        lane_counts, base)
    require(np.array_equal(got.cpu().numpy(), host_trip),
            f"{tag} K2s's triples are the host replay's on every lane")
    W, L = len(lane_counts), max(lane_counts)
    n = int(sum(lane_counts))
    card = int(plan_t["cluster_init"].numel())
    bound = k2s_bound(gpu, W, L, n, sum_x, rescales, card)
    print(f"{tag} K2s cluster-id segment, {W} lanes x {L} lines, {card} "
          f"clusters: equal to its plain version and the host replay "
          f"(max abs err {err}), model 0 rescaling {rescales} times; kernel "
          f"{ms:.4f} ms ({runs}), plain {plain_ms:.3f} ms (median of 3, in "
          f"turns); bound {bound[0]:.5f} ms ({bound[1]}, {bound[2]}; SASS "
          f"instructions by pipe {json.dumps(bound[3])})", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound}


def prologue_check(blob, lanes, tag: str) -> int:
    """K5p's output in `lanes` (pipeline.decode.prepare_lanes) against the
    host's cluster-id prologue (rt.decode_cluster_prologue) lane by lane:
    the ids and (l, u, t, consumed bits) where the host passes, the flag
    of its failure (-3 FLAG_BAD, -1 FLAG_CLUSTER) where it does not, and
    with one cluster the start of the payload's first 22 bits. Returns the
    lanes K5p flagged."""
    import numpy as np
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.pipeline import decode as pdec

    head, tables = pdec._parse(blob)
    cl = lanes.cl.cpu().numpy() if lanes.cl is not None else None
    states = lanes.starts.cpu().numpy()
    flags = lanes.start_flags.cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(lanes.lane_counts)])
    for w, s in enumerate(head.shards[lanes.first:]):
        pay = bytes(blob[s.payload_off:s.payload_off + s.payload_len])
        if cl is None:
            require(tuple(states[w]) == dd.start_state(pay) and not flags[w],
                    f"{tag}: K5p's start of lane {w} is the payload's")
            continue
        try:
            h = rt.decode_cluster_prologue(tables, pay, s.lines,
                                           init_bank=lanes.bank)
        except ValueError as e:
            status = int(str(e).split()[-1])
            require(flags[w] == {-3: dd.FLAG_BAD, -1: dd.FLAG_CLUSTER}[status],
                    f"{tag}: K5p flags lane {w} as the host's status "
                    f"{status}")
            continue
        require(not flags[w] and np.array_equal(cl[offs[w]:offs[w + 1]],
                                                h[0])
                and tuple(states[w]) == tuple(h[1:]),
                f"{tag}: K5p's ids and state of lane {w} are the host "
                "prologue's")
    return int((flags != 0).sum())


def prologue_phase(torch, np, comp, gpu, tag: str, bound: bool = False):
    """K5p on the lanes of a container: against its plain version (on the
    card's tensors) and the host's prologue lane by lane (prologue_check),
    timed in turns with the plain version; with `bound`, its bound from its
    counted SASS (k5p_bound)."""
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.pipeline import decode as pdec

    lanes = pdec.prepare_lanes(comp, "cuda")
    out = {}

    def kernel():
        out["k"] = dd.cluster_prologue(lanes.dplan_t, lanes.pays,
                                       lanes.lane_counts)

    def plain():
        out["p"] = dd.cluster_prologue_reference(lanes.dplan_t, lanes.pays,
                                                 lanes.lane_counts)

    ms, plain_ms, runs, _ = in_turns(kernel, plain, torch, runs=3)
    got = [x for x in out["k"] if x is not None]
    want = [x for x in out["p"] if x is not None]
    err = max_err(got, want)
    require(err == 0 and len(got) == len(want)
            and all(torch.equal(a, b) for a, b in zip(got, want)),
            f"{tag} K5p's ids, states and flags equal its plain version's")
    flagged = prologue_check(comp, lanes, tag)
    require(flagged == 0, f"{tag} K5p flags no lane")
    W, n = len(lanes.lane_counts), int(sum(lanes.lane_counts))
    card = int(lanes.dplan_t["cluster_init"].numel())
    res = {"err": err, "ms": ms, "plain_ms": plain_ms}
    line = (f"{tag} K5p {W} lanes, {card} cluster(s): ids and start states "
            f"equal to its plain version and the host's (max abs err {err}), "
            f"0 flagged; kernel {ms:.4f} ms ({runs}), plain {plain_ms:.3f} ms "
            f"(median of 3, in turns)")
    if bound:
        _, sum_x, rescales = _model0_replay(
            np, lanes.dplan_t["cluster_init"].cpu().numpy(),
            lanes.dplan_t["cluster_total"], lanes.cl.cpu().numpy(),
            lanes.lane_counts, 0)
        pay_bytes = int(-(-lanes.starts[:, 3].cpu() // 8).sum())
        res["bound"] = k5p_bound(gpu, W, n, sum_x, rescales, card, pay_bytes)
        line += (f"; model 0 rescaling {rescales} times, {pay_bytes} payload "
                 f"bytes; bound {res['bound'][0]:.5f} ms ({res['bound'][1]}, "
                 f"{res['bound'][2]}; SASS instructions by pipe "
                 f"{json.dumps(res['bound'][3])})")
    print(line, flush=True)
    return res


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


def k1_phase(torch, tables, data_t, draws_t, ids, gpu, tag: str):
    """K1 against its plain version at this shape, on the tables of
    `tables` (an rt.Tables): element-equal, timed in turns with the plain
    version (median of 5); the bound from its SASS. Returns (result, K1's
    output)."""
    from qvz_tpu_torch.ops import quantize as tq

    cols, n = data_t.shape
    tabs = tq.tables_to_torch(tables, data_t.device, plain=True)
    got = tq.quantize_t_device(tabs, data_t, draws_t, ids)
    want = tq.quantize_reference(tabs, data_t, draws_t, ids)
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(err == 0 and all(torch.equal(a, b) for a, b in zip(got, want)),
            f"{tag} K1 equals its plain version element for element")
    del want
    ms, plain_ms, runs, _ = in_turns(
        lambda: tq.quantize_t_device(tabs, data_t, draws_t, ids),
        lambda: tq.quantize_reference(tabs, data_t, draws_t, ids), torch)
    bound = k1_bound(gpu, tabs, n, cols, ids is not None)
    print(f"{tag} K1 quantize {cols} x {n}, {tabs['n_clusters']} "
          f"cluster(s), {tabs['max_pairs']} pairs a column at most: equal "
          f"(max abs err {err}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
          f"(median of 5, in turns; kernel {[round(r, 4) for r in runs]}); "
          f"bound {bound[0]:.4f} ms ({bound[1]}, {bound[2]}; SASS "
          f"instructions by pipe {json.dumps(bound[3])})", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound}, got


def k4_phase(torch, np, data, data_t, K: int, threshold: float, gpu,
             tag: str, runs: int, host=None) -> dict:
    """K4 at K means from seed_centroids against its plain version (assign,
    sums and counts equal), also with means 0 and 1 identical (every tie
    to the lower index); the kernel (tk.launch, the means packed) timed in
    turns with the plain version (median of `runs`); the bound from its
    SASS; then kmeans_cluster on the card against the host C++
    rt.kmeans_host (`host`, its result where already computed): equal
    assignment, means and iteration count."""
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import kmeans as tk
    from qvz_tpu_torch.spec.kmeans import seed_centroids

    n, cols = data.shape
    dev = data_t.device
    seeds = seed_centroids(data, K).astype(np.int64)
    err = 0
    tie = seeds.copy()
    tie[1] = tie[0]
    for m in (seeds, tie):
        m_t = torch.from_numpy(m).to(dev)
        got = tk.kmeans_step(data_t, m_t)
        want = tk.kmeans_step_reference(data_t, m_t)
        torch.cuda.synchronize()
        err = max(err, max_err(got, want))
        require(err == 0 and all(torch.equal(a, b)
                                 for a, b in zip(got, want)),
                f"{tag} K4 assign, sums and counts equal the plain "
                "version's")
    require(int(got[2][1]) == 0 and int(got[2][0]) > 0,
            f"{tag} K4 with two identical means gives every tie to the "
            "lower one")
    shape = tk.card_step_shape(data_t, K)
    m4 = tk.pack_means(torch.from_numpy(seeds), shape["k_pad"]).to(dev)
    m_t = torch.from_numpy(seeds).to(dev)
    def kernel():
        tk.launch(data_t, m4, K, shape)

    def plain():
        tk.kmeans_step_reference(data_t, m_t)

    ms, plain_ms, k_runs, p_runs = in_turns(kernel, plain, torch, runs)
    bound = k4_bound(gpu, shape, n, cols, K)
    t = time.perf_counter()
    assign, means, iters = tk.kmeans_cluster(data, K, threshold,
                                             data_t=data_t)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    t = time.perf_counter()
    h_assign, h_means, h_iters = host or rt.kmeans_host(data, K, threshold)
    host_secs = time.perf_counter() - t
    assign = assign.cpu().numpy()
    require(np.array_equal(assign, h_assign)
            and np.array_equal(means, h_means) and iters == h_iters,
            f"{tag} kmeans_cluster at K = {K} on the card equals "
            "rt.kmeans_host")
    sizes = np.bincount(assign, minlength=K)
    print(f"{tag} K4 k-means step {n} x {cols}, K={K} (tile {shape['T']} "
          f"reads, mode {shape['mode']}, kt {shape['kt']}, "
          f"{shape['grid']} blocks): equal (max abs err {err}), ties to the "
          f"lower index; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms (median of {runs}, in turns; kernel "
          f"{[round(r, 4) for r in k_runs]}, plain "
          f"{[round(r, 3) for r in p_runs]}); bound {bound[0]:.4f} ms "
          f"({bound[1]}, {bound[2]}; SASS instructions by pipe "
          f"{json.dumps(bound[3])})", flush=True)
    print(f"{tag} kmeans_cluster K={K} -T {threshold:g}: {iters} iterations "
          f"(rt.kmeans_host {h_iters}), cluster sizes {sizes.min()}-"
          f"{sizes.max()}, equal to rt.kmeans_host; {secs:.4f} s on the "
          f"card ({iters} steps x {ms:.4f} ms = {iters * ms / 1e3:.4f} s of "
          f"kernel){'' if host else f', {host_secs:.4f} s on the host'}",
          flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound,
            "assign": assign, "iters": iters}


def binned(data):
    """Each symbol to the nearest of the four Phred values a NovaSeq's
    RTA3 bins qualities to (2, 12, 23, 37; the lower on a tie)."""
    import numpy as np
    nova = np.array([2, 12, 23, 37], np.int16)
    return nova[np.abs(data[..., None].astype(np.int16) - nova).argmin(-1)
                ].astype(np.uint8)


def k3_phase(torch, np, data, data_t, ids, ids_h, K: int, gpu) -> dict:
    """Phase 7: K3 against its plain version and rt.stats_host at C = 1
    and C = K (the k-means ids), on the Illumina-like input and on its
    NovaSeq-binned copy, each timed in turns with the plain version
    (median of 5); its bound from its counted SASS, and the zeroing of
    its outputs (two torch.zeros) timed alone; at odd shapes against the
    plain version; torch.bincount over the combined index at
    C = 1 and C = K, K3's library yardstick (the port never calls it)."""
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import stats as ts

    n, cols = data.shape
    dev = data_t.device
    A = 72
    res = {"err": 0, "ms": {}, "plain_ms": {}, "zero_ms": {}, "lib_ms": {},
           "bound": {}}
    inputs = (("illumina", data, data_t),
              ("binned", binned(data), None))
    for name, d, d_t in inputs:
        if d_t is None:
            d_t = torch.from_numpy(np.ascontiguousarray(d.T)).to(dev)
        for c, cl, cl_h in ((1, None, None), (K, ids, ids_h)):
            key = f"{name} C={c}"
            got = ts.conditional_counts_t(d_t, cl, c)
            want = ts.conditional_counts_reference(d_t, cl, c)
            torch.cuda.synchronize()
            counts_h = rt.stats_host(d, cl_h, c)
            err = max_err(got, want)
            res["err"] = max(res["err"], err)
            require(err == 0 and all(torch.equal(a, b)
                                     for a, b in zip(got, want))
                    and all(np.array_equal(a.cpu().numpy(), b)
                            for a, b in zip(got, counts_h)),
                    f"[7] K3 {key} equals its plain version and "
                    "rt.stats_host")
            del got, want, counts_h
            shape = ts.card_hist_shape(d_t, c)
            ms, plain_ms, k_runs, _ = in_turns(
                lambda: ts.conditional_counts_t(d_t, cl, c),
                lambda: ts.conditional_counts_reference(d_t, cl, c), torch)
            res["ms"][key], res["plain_ms"][key] = ms, plain_ms
            if name == "illumina":
                res["bound"][c] = k3_bound(gpu, shape, n, cols, c)
                size = c * A + c * (cols - 1) * A * A
                res["zero_ms"][c] = statistics.median(event_ms(
                    lambda: (torch.zeros((c, A), dtype=torch.long,
                                         device=dev),
                             torch.zeros((c, cols - 1, A, A),
                                         dtype=torch.long, device=dev)),
                    torch) for _ in range(5))
            print(f"[7] K3 {cols} x {n} {key} (mode {shape['mode']}, band "
                  f"{shape['band']}, {shape['nbands']} x {shape['nslices']} "
                  f"blocks of {shape['threads']}): equal to the plain "
                  f"version and rt.stats_host (max abs err {err}); kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.3f} ms (median of 5, in "
                  f"turns; kernel {[round(r, 4) for r in k_runs]})"
                  + (f"; the outputs' zeroing (two torch.zeros, "
                     f"{8 * size / 1e6:.1f} MB, inside the call) "
                     f"{res['zero_ms'][c]:.4f} ms alone (median of 5)"
                     f"; bound {res['bound'][c][0]:.4f} ms "
                     f"({res['bound'][c][1]}, {res['bound'][c][2]}; SASS "
                     f"instructions by pipe {json.dumps(res['bound'][c][3])}"
                     ")" if name == "illumina" else ""), flush=True)
            if name == "illumina":
                # the library yardstick: one torch.bincount over the
                # combined (column, cluster*72 + previous, current) index,
                # built outside the timing
                q = (cl.long() if cl is not None
                     else torch.zeros(n, dtype=torch.long, device=dev))
                idx = ((q * A + d_t[:-1].long()) * A + d_t[1:].long()
                       + torch.arange(cols - 1, device=dev)[:, None]
                       * (c * A * A)).reshape(-1)
                size = (cols - 1) * c * A * A
                lib = torch.bincount(idx, minlength=size)
                require(torch.equal(lib.reshape(cols - 1, c, A, A).permute(
                    1, 0, 2, 3), ts.conditional_counts_t(d_t, cl, c)[1]),
                    f"[7] torch.bincount gives K3's counts at C={c}")
                res["lib_ms"][c] = statistics.median(event_ms(
                    lambda: torch.bincount(idx, minlength=size), torch)
                    for _ in range(5))
                print(f"[7] torch.bincount over the combined index, C={c}: "
                      f"{res['lib_ms'][c]:.3f} ms (median of 5), equal to "
                      "K3", flush=True)
                del q, idx, lib
        del d_t
    # odd shapes against the plain version over the reads K3 counts; a
    # ragged N takes the 4-byte or byte loads; `bad` reads get an id at or
    # past C, which K3 does not count
    rng = np.random.default_rng(7)
    odd = []
    for sn, sc, sk, bad in ((1, 1, 1, 0), (1037, 1, 3, 0), (4099, 2, 1, 0),
                            (5000, 100, 11, 0), (5000, 100, 12, 0),
                            (3000, 30, 255, 0), (3001, 7, 2, 0),
                            (4100, 33, 5, 0), (3001, 7, 2, 40),
                            (2000, 9, 12, 40)):
        sd = torch.from_numpy(np.ascontiguousarray(
            make_input(sn, sc, sn).T)).to(dev)
        sq_h = rng.integers(0, sk, sn).astype(np.uint8)
        sq_h[rng.choice(sn, bad, replace=False)] = rng.integers(sk, 256, bad)
        keep = torch.from_numpy(sq_h < sk).to(dev)
        sq = torch.from_numpy(sq_h).to(dev)
        want = ts.conditional_counts_reference(sd[:, keep], sq[keep], sk)
        got = ts.conditional_counts_t(sd, sq, sk)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"[7] K3 at {sn} x {sc}, C={sk}, {bad} ids out of range, "
                "equals its plain version over the reads it counts")
        odd.append((sn, sc, sk, bad, ts.card_hist_shape(sd, sk)["mode"]))
    require({o[4] for o in odd if o[3]} == {0, 1}, "[7] the odd shapes "
            "run both of K3's modes with ids out of range")
    print(f"[7] K3 equal to its plain version at (N, cols, C, ids out of "
          f"range, mode) {odd}", flush=True)
    return res


def clustered_phases(torch, np, data, dist, gpu) -> dict:
    """Phases 6-10: the -c 3 -T 4 path. Returns the kernels' errors and
    times, the encodes' medians and the encodes' kernel launches."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.constants import MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import kmeans as tk
    from qvz_tpu_torch.ops import stats as ts
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host

    K, T = 3, 4.0
    dev = torch.device("cuda")
    n, cols = data.shape
    data_t = torch.from_numpy(np.ascontiguousarray(data.T)).to(dev)
    res = {}

    # -- 6. K4 -------------------------------------------------------------
    k4 = k4_phase(torch, np, data, data_t, K, T, gpu, "[6]", runs=5)
    # small and odd shapes: 16-read tiles, N not a multiple of 4 or 16,
    # the 1,022-column ceiling, sums in shared memory (mode 1) and, at the
    # ceiling with 255 means, in device memory with the means unshared
    # (mode 2)
    small = []
    for sn, sc, sk in ((1037, 100, 3), (4100, 20, 150), (999, 1022, 9),
                       (8448, 100, 3), (5000, 40, 11), (700, 1022, 255)):
        sd = torch.from_numpy(np.ascontiguousarray(
            make_input(sn, sc, sk).T)).to(dev)
        sm = torch.from_numpy(np.ascontiguousarray(
            make_input(sk, sc, sn)).astype(np.int64)).to(dev)
        got = tk.kmeans_step(sd, sm)
        want = tk.kmeans_step_reference(sd, sm)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"[6] K4 at {sn} x {sc}, K={sk} equals its plain version")
        shape = tk.card_step_shape(sd, sk)
        small.append((sn, sc, sk, shape["T"], shape["mode"]))
    require({s[-1] for s in small} == {0, 1, 2},
            "[6] the small shapes run K4's three sums modes")
    print(f"[6] K4 equal to its plain version at (N, cols, K, tile, mode) "
          f"{small}", flush=True)
    clusters = k4["assign"]
    res.update(k4_err=k4["err"], k4_ms=k4["ms"], k4_plain_ms=k4["plain_ms"],
               k4_bound=k4["bound"], k4_iters=k4["iters"])
    assign_dev = torch.from_numpy(clusters).to(dev)

    # -- 7. K3 -------------------------------------------------------------
    res["k3"] = k3_phase(torch, np, data, data_t, assign_dev, clusters, K,
                         gpu)
    cl_t = assign_dev

    # -- 8. K1 with the cluster ids -----------------------------------------
    c0, cond = ts.conditional_counts_t(data_t, cl_t, K)
    tables = rt.Design(c0.cpu().numpy(), cond.cpu().numpy(), MODE_RATIO,
                       0.5, dist).tables()
    counts, states, offs, prime_on = port.shard_plan(
        n, cols, port.device_lane_count(n), True, WellState.debug())
    draws = host._shard_draws(states, counts, cols)
    draws_t = torch.from_numpy(draws).to(dev).t().contiguous()
    res["counts8"] = (c0.cpu().numpy(), cond.cpu().numpy())
    res["ids"] = clusters
    res["k1"], (mid, qs, _) = k1_phase(torch, tables, data_t, draws_t, cl_t,
                                       gpu, "[8]")
    del draws_t

    # -- 9. K2 with the cluster-id segment -----------------------------------
    w_n = int(counts[0])
    md0, qs0, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data[:w_n].T), clusters[:w_n],
        states[0])
    plan = cd.LanePlan(tables, rt.bank_from_stream(
        tables, md0, qs0, clusters[:w_n], w_n))
    plan_t = cd.plan_to_torch(plan, dev)
    lane_counts, base = counts[1:], int(offs[1])
    res["k2s"] = segment_phase(torch, np, plan, plan_t, cl_t, clusters,
                               lane_counts, base, gpu, "[9]")
    res["k2"] = coder_phase(torch, np, plan_t, mid, qs, lane_counts, base,
                            cl_t, gpu, "[9]")
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
              f"{json.dumps(phases)}; the cluster phase against its "
              f"{res['k4_iters']} K4 steps: {phases['cluster'] * 1e3:.3f} "
              f"ms, {res['k4_iters'] * res['k4_ms']:.3f} ms of kernel",
              flush=True)
    res["launches"] = dict(_build.LAUNCHES)
    print(f"[10] kernel launches by the -c 3 encodes: {res['launches']}")
    for name in ("hist", "kmeans", "quantize", "coder_segment",
                 "coder_triples", "coder_chain"):
        require(res["launches"].get(name, 0) >= 1,
                f"the -c 3 encode launched {name}")
    return res


def decode_phases(torch, np, containers, dist, gpu, k2) -> dict:
    """Phases 11-13: the device decode of the four containers of phases 5
    and 10, and a container whose lanes reach the rescale. k2: phase 4's
    record of the -c 1 primed lanes (their live steps and symbol indices,
    for K5's bound). Returns K5's error and times, the decodes' medians
    and their kernel launches."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import decode as port
    from qvz_tpu_torch.pipeline import encode as penc
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
        risk = cd.risk_tables(lanes.dplan_t, max(lanes.lane_counts))
        line = (f"[11] K5 {name}: {len(lanes.lane_counts)} lanes, "
                f"{risk['models']} models at risk, 2 columns "
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
            res["bound"] = k5_bound(gpu, lanes, cols, k2["live"],
                                    k2["sum_x"])
            line += (f"; plain over all columns {res['plain_all_ms']:.1f} "
                     f"ms, equal; bound {res['bound'][0]:.4f} ms "
                     f"({res['bound'][1]}, {res['bound'][2]}; SASS "
                     f"instructions by pipe {json.dumps(res['bound'][3])})")
        print(line, flush=True)
        res["err"] = max(res["err"], err)
        res["ms"][name], res["plain_ms"][name] = k5, k5_plain
        res["all_ms"][name] = all_ms
        del lanes, outs

    # -- 12. K5p on each container, then the end-to-end decode -------------
    res["k5p"] = {}
    for name, (comp, _) in containers.items():
        res["k5p"][name] = prologue_phase(
            torch, np, comp, gpu, f"[12] {name}:",
            bound=name == "-c 3 prime=True")
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
        print(f"[12] decode {name}: prologue phase {phases['prologue']:.6f}"
              f" s of {secs:.6f} s, decoder phase {phases['decoder']:.6f} s "
              "(last run)", flush=True)
        print(f"[12] decode {name}: byte-equal to the host decoder and the "
              f"-u reconstruction, {st['lanes']} lanes, 0 flagged; median "
              f"of 3 {secs:.4f} s = {mb / secs:.1f} MB/s (runs "
              f"{[round(r, 4) for r in runs]}); host decoder {host_secs:.4f}"
              f" s = {mb / host_secs:.1f} MB/s; {st['waves']} wave(s); "
              f"phases {json.dumps(phases)}; first decode: {mem}",
              flush=True)
    res["launches"] = dict(_build.LAUNCHES)
    print(f"[12] kernel launches by the decodes: {res['launches']}")
    for name in ("cluster_prologue", "decoder"):
        require(res["launches"].get(name, 0) >= 1,
                f"the decode launched {name}")

    # -- 13. lanes that reach the rescale, on the card ----------------------
    rng = np.random.default_rng(1)
    data = np.clip(30 + rng.integers(-1, 2, size=(300_000, 2)).cumsum(1), 0,
                   71).astype(np.uint8)
    ref = host.encode(data, dist, well_state=WellState.debug(), shards=2,
                      prime=False)
    comp = ref.compressed
    _build.LAUNCHES.clear()
    t = time.perf_counter()
    enc = penc.encode(data, dist, well_state=WellState.debug(), shards=2,
                      prime=False, device="cuda")
    enc_secs = time.perf_counter() - t
    st = {}
    t = time.perf_counter()
    got = port.decode(comp, device="cuda", stats=st)
    dec_secs = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    require(enc.compressed == comp and enc.stats.coder_fallback_lanes == 0,
            "the device encode of the rescale input is byte-equal to the "
            "host engine, no lane coded on the host")
    require(np.array_equal(got, host.decode(comp))
            and st["fallback_lanes"] == 0,
            "the device decode of the rescale input is byte-equal to the "
            "host decoder, no lane flagged")
    for name in ("coder_triples", "coder_chain", "cluster_prologue",
                 "decoder"):
        require(launches.get(name, 0) >= 1, f"[13] launched {name}")
    lanes = port.prepare_lanes(comp, "cuda")
    risk = cd.risk_tables(lanes.dplan_t, max(lanes.lane_counts))
    require(risk["models"] >= 1, "the rescale input has models at risk")
    del lanes
    print(f"[13] 300000 x 2, 2 lanes, unprimed: {risk['models']} models at "
          f"risk; encode on the card {enc_secs:.3f} s, byte-equal to the "
          f"host engine, coder_fallback_lanes 0; decode(device='cuda') "
          f"{dec_secs:.3f} s, byte-equal to the host decoder, 0 flagged; "
          f"launches {launches}; decode phases "
          f"{json.dumps({k: round(v, 6) for k, v in st['phase_seconds'].items()})}",
          flush=True)
    res["rescale"] = rescale_case(torch, np, dist)

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


RESCALE_LANES, RESCALE_LINES = 16, 36_000   # phase 13's rescale case


def pending_runs(torch, np, dev="cuda") -> None:
    """K2b against its plain version and a bit writer's bits at pending
    runs of s3 = 31, 32, 53, 62, 63 and 100 bits (K2b's two emissions: up
    to 32 bits at once, longer runs in pieces): one lane a run and half,
    from the full interval with 5 bits pending, one step onto the lower
    (first bit 0, the run of 1s) or the upper half (1, then 0s)."""
    from qvz_tpu_torch.ops import coder_device as cd

    runs = (31, 32, 53, 62, 63, 100)
    W = 2 * len(runs)
    raw = cd.start_raw(W, "cpu", 8)
    raw[2][2] = torch.tensor(runs * 2)
    raw[2][3], raw[2][4] = 0b10110, 5
    upper = torch.arange(W) >= len(runs)
    trip = cd.pack_triples(upper.long(), upper.long() + 1,
                           torch.full((W,), 2))[None]
    want = cd.fetch_lanes(*cd.chain_reference(trip, 1, [1] * W,
                                              [r.clone() for r in raw]))
    got = cd.fetch_lanes(*cd.chain(trip.to(dev), 1, [1] * W,
                                   [r.to(dev) for r in raw]))
    require(all(np.array_equal(a, b) for a, b in zip(got, want)),
            "K2b equals its plain version at pending runs of 31-100 bits")
    words, n_words, carry = want
    for w, s3 in enumerate(runs * 2):
        first = int(upper[w])
        bits = "10110" + str(first) + str(1 - first) * s3
        nw = len(bits) // 32
        rest = bits[32 * nw:]
        require(int(n_words[w]) == nw and all(
            int(words[w, k]) & 0xFFFFFFFF == int(bits[32 * k:32 * k + 32], 2)
            for k in range(nw)) and int(carry[4, w]) == len(rest)
                and int(carry[3, w]) == int(rest or "0", 2)
                and int(carry[2, w]) == 0,
                f"K2b's bits at a pending run of {s3} are the bit writer's")


def rescale_case(torch, np, dist, dev="cuda", lanes=RESCALE_LANES,
                 lines=RESCALE_LINES, rescales=2, tag="[13]") -> dict:
    """Phase 13's rescale case: K2a, K2b and K5 against their plain
    versions (on CPU tensors, the same inputs) in each of layouts 0, 1 and
    2, forced, on a -c 3 plan whose lanes rescale, and K2s and K5p against
    theirs and the host's replay and prologue. `lanes` lanes of about
    `lines` reads x 1 column (30 or 31 at -f 1.0: one model a cluster),
    cluster ids 0 for 97% of the reads, unprimed but for a bank whose
    models of clusters 0 and 1 start 24 and 8,000 short of 2^19, and the
    cluster-id model (model 0) 24 short: cluster 0's model and model 0
    rescale `rescales` times or more in lane 0 (counted by a replay of the
    host's update; twice at the defaults), cluster 1's once where its
    lanes are long enough. K2b is held against its plain version over the
    column, both from K2b's state after the cluster-id segment; every
    lane's payload equals the host coder's, its decode the host
    decoder's, and no lane is flagged. Then pending_runs. Returns the
    kernels' times (ms) and the plain versions' (ms, CPU)."""
    from qvz_tpu_torch.constants import ARITH_R, MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import host

    W, cols, K = lanes, 1, 3
    n = W * lines - lines // 50                    # a ragged last lane
    rng = np.random.default_rng(13)
    data = (30 + rng.integers(0, 2, (n, cols))).astype(np.uint8)
    cl = np.where(rng.random(n) < 0.97, 0,
                  rng.integers(1, K, n)).astype(np.uint8)
    c0, cond = rt.stats_host(data, cl, K)
    tables = rt.Design(c0, cond, MODE_RATIO, 1.0, dist).tables()
    counts, states, offs, _ = host.shard_plan(n, cols, W, False,
                                              WellState.debug())
    lane_counts = [int(c) for c in counts]
    md = np.empty((cols, n), np.uint32)
    qs = np.empty((cols, n), np.uint8)
    for w in range(W):
        lo, hi = offs[w], offs[w + 1]
        md[:, lo:hi], qs[:, lo:hi], _, _ = rt.quantize_colmajor(
            tables, np.ascontiguousarray(data[lo:hi].T), cl[lo:hi],
            states[w])
    cards = np.asarray(tables.model_card, dtype=np.int64)
    moff = np.asarray(tables.model_off, dtype=np.int64)
    bcounts = np.ones(int(moff[-1]), dtype=np.uint32)
    totals = cards.astype(np.uint32)
    busy = []
    for k, short in ((0, 24), (1, 8000)):
        ids, f = np.unique(md[0][cl == k], return_counts=True)
        m = int(ids[f.argmax()])
        require(cards[m] > 1, f"cluster {k}'s model is live")
        bcounts[moff[m]] = ARITH_R - short - (cards[m] - 1)
        totals[m] = ARITH_R - short
        busy.append(m)
    bcounts[0] = ARITH_R - 24 - (K - 1)            # model 0, the ids'
    totals[0] = ARITH_R - 24
    bank = np.concatenate([bcounts, totals])

    # the host's update of cluster 0's model over lane 0: its rescales
    m = busy[0]
    c = bcounts[moff[m]:moff[m] + cards[m]].astype(np.int64)
    twice = 0
    for x in qs[0, :lane_counts[0]][md[0, :lane_counts[0]] == m]:
        c[x] += 8
        if c.sum() > ARITH_R:
            c = (c >> 1) + 1
            twice += 1
    require(twice >= rescales,
            f"a model rescales {rescales} times in lane 0 ({twice})")
    ids0 = rt.replay_model(bcounts[:K], totals[0], cl[:lane_counts[0]])
    twice0 = int((ids0[1:, 2] != ids0[:-1, 2] + 8).sum())
    require(twice0 >= rescales,
            f"model 0 rescales {rescales} times in lane 0 ({twice0})")

    pays = [rt.encode_precomputed_colmajor(
        tables, np.ascontiguousarray(md[:, offs[w]:offs[w + 1]]),
        np.ascontiguousarray(qs[:, offs[w]:offs[w + 1]]),
        cl[offs[w]:offs[w + 1]], lane_counts[w], init_bank=bank)
        for w in range(W)]
    plan = cd.LanePlan(tables, bank)
    plan_c, plan_d = cd.plan_to_torch(plan, "cpu"), cd.plan_to_torch(plan,
                                                                      dev)
    cl_c = torch.from_numpy(cl)
    cl_d = cl_c.to(dev)
    mid_c = torch.from_numpy(md.astype(np.int32))
    qs_c = torch.from_numpy(qs.astype(np.int32))
    mid_d, qs_d = mid_c.to(dev), qs_c.to(dev)
    L = max(lane_counts)
    risk = cd.risk_tables(plan_d, L)
    require(risk["models"] >= 1, f"models at risk: {risk['models']}")
    res = {"a_ms": {}, "k5_ms": {}, "plain_ms": {}}

    def ms(fn, runs=3):
        return statistics.median(event_ms(fn, torch) for _ in range(runs))

    # -- K2a ---------------------------------------------------------------
    t = time.perf_counter()
    trip_p = cd.triples_reference(plan_c, mid_c, qs_c, lane_counts, 0, 0,
                                  cols)
    res["plain_ms"]["coder_triples"] = (time.perf_counter() - t) * 1e3
    for lay in (0, 1, 2):
        def a_run():
            return cd.triples(plan_d, mid_d, qs_d, lane_counts, 0, 0, cols,
                              layout=lay)

        require(torch.equal(a_run().cpu(), trip_p),
                f"{tag} K2a in layout {lay} equals its plain version on the "
                "rescale case")
        res["a_ms"][lay] = ms(a_run)

    # -- K2s, the cluster-id segment through model 0's rescales -------------
    t = time.perf_counter()
    seg_p = cd.segment_triples_reference(plan_c, cl_c, lane_counts, 0)
    res["plain_ms"]["coder_segment"] = (time.perf_counter() - t) * 1e3
    seg_d = cd.segment_triples(plan_d, cl_d, lane_counts, 0)
    require(torch.equal(seg_d.cpu(), seg_p),
            f"{tag} K2s equals its plain version on the rescale case")
    for w in range(W):
        h = rt.replay_model(plan.cluster_init_counts,
                            plan.cluster_init_total,
                            cl[offs[w]:offs[w + 1]]).astype(np.int64)
        require(np.array_equal(seg_p[:lane_counts[w], w].numpy(),
                               h[:, 0] | (h[:, 1] << 20) | (h[:, 2] << 40)),
                f"{tag} K2s's triples of lane {w} are the host replay's")
    res["k2s_ms"] = ms(lambda: cd.segment_triples(plan_d, cl_d, lane_counts,
                                                  0))

    # -- K2b over the column, from its state after the cluster-id segment --
    mw = -(-(cols + 1) * L * cd.BITS_PER_STEP_BOUND // 32) + 2
    trip_d = trip_p.to(dev)
    after = [r.cpu().clone() for r in cd.chain(seg_d, 1, lane_counts,
                                                cd.start_raw(W, dev, mw))]
    t = time.perf_counter()
    want = cd.chain_reference(trip_p, cols, lane_counts, after)
    res["plain_ms"]["coder_chain"] = (time.perf_counter() - t) * 1e3
    b_runs = []
    for _ in range(3):
        raw = [r.to(dev).clone() for r in after]
        box = []
        b_runs.append(ms(lambda: box.append(
            cd.chain(trip_d, cols, lane_counts, raw)), 1))
    got = box[0]
    res["b_ms"] = statistics.median(b_runs)
    (wk, nk, ck), (wp, np_, cp) = (cd.fetch_lanes(*r) for r in (got, want))
    require(np.array_equal(nk, np_) and np.array_equal(ck, cp)
            and all(np.array_equal(wk[w, :nk[w]], wp[w, :np_[w]])
                    for w in range(W)),
            f"{tag} K2b equals its plain version on the rescale case")
    require(cd.payloads_from_raw(wk, nk, ck)[0] == pays,
            f"{tag} K2 gives the host coder's payload in every lane")
    full = cd.encode_lanes_raw(plan_d, mid_d, qs_d, lane_counts, 0, cl_d)
    require(full[0] == pays and not full[1].any(),
            f"{tag} code_lanes gives the host coder's payloads, no lane "
            "flagged")

    # -- K5p: the cluster-id prologues through model 0's rescales --------
    dplan = dd.DecodePlan(plan, tables)
    dplan_c, dplan_d = (dd.decode_plan_to_torch(dplan, "cpu"),
                        dd.decode_plan_to_torch(dplan, dev))
    pays_c, pays_d = dd.pack_payloads(pays, "cpu"), dd.pack_payloads(pays,
                                                                      dev)
    t = time.perf_counter()
    pro_p = dd.cluster_prologue_reference(dplan_c, pays_c, lane_counts)
    res["plain_ms"]["cluster_prologue"] = (time.perf_counter() - t) * 1e3
    pro_d = dd.cluster_prologue(dplan_d, pays_d, lane_counts)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(pro_d, pro_p)),
            f"{tag} K5p equals its plain version on the rescale case")
    for w in range(W):
        h = rt.decode_cluster_prologue(tables, pays[w], lane_counts[w],
                                       init_bank=bank)
        require(np.array_equal(pro_p[0][offs[w]:offs[w + 1]].numpy(), h[0])
                and pro_p[1][w].tolist() == list(h[1:])
                and int(pro_p[2][w]) == 0,
                f"{tag} K5p's ids and state of lane {w} are the host "
                "prologue's")
    require(np.array_equal(pro_p[0].numpy(), cl),
            f"{tag} the prologues give the cluster ids")
    res["k5p_ms"] = ms(lambda: dd.cluster_prologue(dplan_d, pays_d,
                                                   lane_counts))
    starts = pro_p[1]
    draws_t = torch.from_numpy(np.ascontiguousarray(
        host._shard_draws(states, lane_counts, cols).T))
    args_c = (dplan_c, pays_c, draws_t, cl_c, lane_counts, 0, starts)
    args_d = (dplan_d, pays_d, draws_t.to(dev), pro_d[0], lane_counts, 0,
              pro_d[1])
    out_p = torch.zeros((n, cols + 1), dtype=torch.uint8)
    t = time.perf_counter()
    fin_p = dd.decode_lanes_reference(*args_c, out_p, 33)
    res["plain_ms"]["decoder"] = (time.perf_counter() - t) * 1e3
    want_rows = np.concatenate([rt.decode_colmajor(
        tables, pays[w], lane_counts[w], states[w], init_bank=bank)
        for w in range(W)])
    require(np.array_equal(out_p.numpy(), want_rows)
            and not (fin_p[:, 4] != 0).any(),
            f"{tag} K5's plain version gives the host decoder's rows, no lane "
            "flagged")
    for lay in (0, 1, 2):
        out_k = torch.zeros((n, cols + 1), dtype=torch.uint8, device=dev)

        def k5_run():
            return dd.decode_lanes_t(*args_d, out_k, 33, layout=lay)

        fin_k = k5_run()
        require(torch.equal(fin_k.cpu(), fin_p)
                and torch.equal(out_k.cpu(), out_p),
                f"{tag} K5 in layout {lay} equals its plain version on the "
                "rescale case")
        res["k5_ms"][lay] = ms(k5_run)
    pending_runs(torch, np, dev)
    print(f"{tag} rescale case, -c {K}, {W} lanes of {lane_counts[0]} reads "
          f"(last {lane_counts[-1]}) x {cols} column: {risk['models']} "
          f"models at risk (K2a records {8 * W * int(risk['roff_h'][-1])} B, "
          f"K5 {8 * W * risk['rec_max']} B), cluster 0's model rescaling "
          f"{twice} times in lane 0 and model 0 {twice0} times; every "
          f"lane's payload the host coder's and its decode the host "
          f"decoder's, 0 flagged; K2s's triples the host replay's and K5p's "
          f"ids and states the host prologue's; equal to the plain "
          f"versions: K2s {res['k2s_ms']:.3f} ms, K5p {res['k5p_ms']:.3f} "
          f"ms, K2a layouts 0/1/2 "
          + "/".join(f"{v:.3f}" for v in res["a_ms"].values())
          + f" ms, K2b {res['b_ms']:.3f} ms, K5 layouts 0/1/2 "
          + "/".join(f"{v:.3f}" for v in res["k5_ms"].values())
          + " ms (median of 3); plain on the CPU, one run: "
          + ", ".join(f"{k} {v:.0f} ms" for k, v in res["plain_ms"].items())
          + "; K2b at pending runs of 31-100 bits equal to its plain version "
          "and the bit writer", flush=True)
    return res


def k3_big(torch, np, data_t, cl_t, host_counts, K: int, gpu) -> dict:
    """K3 at K clusters (phase 16: the increments in device memory, a
    warp's equal bins merged) against its plain version and the host's
    counts, timed in turns with the plain version (median of 5); its
    bound from its counted SASS."""
    from qvz_tpu_torch.ops import stats as ts

    cols, n = data_t.shape
    shape = ts.card_hist_shape(data_t, K)
    got = ts.conditional_counts_t(data_t, cl_t, K)
    want = ts.conditional_counts_reference(data_t, cl_t, K)
    torch.cuda.synchronize()
    err = max_err(got, want)
    host_counts_t = [torch.from_numpy(h).to(data_t.device)
                     for h in host_counts]
    require(err == 0 and all(torch.equal(a, b) for a, b in zip(got, want))
            and all(torch.equal(a, b) for a, b in zip(got, host_counts_t)),
            f"[16] K3 at C={K} equals its plain version and rt.stats_host")
    del got, want
    ms, plain_ms, runs, _ = in_turns(
        lambda: ts.conditional_counts_t(data_t, cl_t, K),
        lambda: ts.conditional_counts_reference(data_t, cl_t, K), torch)
    bound = k3_bound(gpu, shape, n, cols, K)
    print(f"[16] K3 {cols} x {n}, C={K} (mode {shape['mode']}, band "
          f"{shape['band']}, {shape['nbands']} x {shape['nslices']} blocks "
          f"of {shape['threads']}): equal to the plain version and "
          f"rt.stats_host (max abs err {err}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms (median of 5, in turns; kernel "
          f"{[round(r, 4) for r in runs]}); bound {bound[0]:.4f} ms "
          f"({bound[1]}, {bound[2]}; SASS instructions by pipe "
          f"{json.dumps(bound[3])})", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound}


def big_plan_phase(torch, np, dist, gpu) -> dict:
    """Phase 16: a plan too large for K5's shared-memory layout. 200,000 x
    20 of the phase-2 generator at -c BIG_K (K5 stages the plan at one
    cluster fewer): the encode and decode(device="cuda") run every lane on
    the card, K2a and K5 reading the plan's tables from device memory;
    then K4 at K = BIG_K and kmeans_cluster against rt.kmeans_host (as in
    phase 6), K1 in each layout that holds the plan, and K2a and K5 in
    each layout that holds the plan against their plain versions over all
    columns. Returns K1's and K4's errors."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.constants import MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import decode as pdec
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host

    n, cols, K = 200_000, 20, BIG_K
    dev = torch.device("cuda")
    data = make_input(n, cols, 42)
    fits = {}
    for k in (K - 1, K):
        km = rt.kmeans_host(data, k, 4.0)
        cl = km[0]
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
    for name in ("hist", "kmeans", "quantize", "coder_segment",
                 "coder_triples", "coder_chain", "cluster_prologue",
                 "decoder"):
        require(launches.get(name, 0) >= 1, f"-c {K}: {name} launched")

    # -- each layout that holds the plan against the plain versions --------
    data_t = torch.from_numpy(np.ascontiguousarray(data.T)).to(dev)
    counts, states, offs, _ = port.shard_plan(
        n, cols, port.device_lane_count(n), True, WellState.debug())
    draws_t = torch.from_numpy(host._shard_draws(states, counts, cols)).to(
        dev).t().contiguous()
    k4 = k4_phase(torch, np, data, data_t, K, 4.0, gpu, "[16]", runs=3,
                  host=km)
    cl_t = torch.from_numpy(cl).to(dev)
    k3 = k3_big(torch, np, data_t, cl_t, (c0, cond), K, gpu)
    k1, (mid, qs, _) = k1_phase(torch, tables, data_t, draws_t, cl_t, gpu,
                                "[16]")
    plan = cd.LanePlan(tables, None)
    plan_t = cd.plan_to_torch(plan, dev)
    lane_counts, base = counts[1:], int(offs[1])
    k2s = segment_phase(torch, np, plan, plan_t, cl_t, cl, lane_counts, base,
                        gpu, f"[16] -c {K}:")
    k5p = prologue_phase(torch, np, out.compressed, gpu, f"[16] -c {K}:")
    want = cd.triples_reference(plan_t, mid, qs, lane_counts, base, 0, cols)
    a_ms = {}
    for lay in (1, 2):
        def a_run():
            return cd.triples(plan_t, mid, qs, lane_counts, base, 0, cols,
                              layout=lay)

        trip = a_run()
        require(torch.equal(trip, want),
                f"-c {K}: K2a in layout {lay} equals its plain version")
        a_ms[lay] = statistics.median(event_ms(a_run, torch)
                                      for _ in range(3))
    del want, trip, mid, qs, data_t, draws_t

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
    return {"k1_err": k1["err"], "k4_err": k4["err"], "k3": k3,
            "k2s_err": k2s["err"], "k5p_err": k5p["err"]}


# A child interpreter of phase 17: brings up its CUDA context, then runs
# qvz_tpu_torch.cli.main on its arguments and prints one JSON line: its
# return code, the context's seconds and cli.main's, its kernel launches,
# its peak device memory, and its peak resident set (ru_maxrss, kB) with
# the context up and at the end. It wraps the pipeline's encode and decode,
# so the CLI's output is unchanged: the encode's coder_fallback_lanes, the
# host seconds and calls of rt.encode_precomputed_colmajor on the main
# thread inside the encode (the re-coding of flagged lanes; the warmup
# shard is coded in another thread), and the decode's fallback_lanes and
# phases.
STREAM_CHILD = r"""
import json, resource, sys, threading, time
import torch
from qvz_tpu_torch import _build, cli
from qvz_tpu_torch.pipeline import decode as dm, encode as em
t = time.perf_counter()
torch.zeros(1, device="cuda")
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
seen = {}
enc, dec, code = em.encode, dm.decode, em.rt.encode_precomputed_colmajor
def encode(*a, **k):
    seen.update(recode_s=0.0, recode_calls=0)
    out = enc(*a, **k)
    seen["coder_fallback_lanes"] = out.stats.coder_fallback_lanes
    seen["encode_phases"] = dict(out.stats.phase_seconds)
    return out
def recode(*a, **k):
    t0 = time.perf_counter()
    r = code(*a, **k)
    if "recode_s" in seen and threading.current_thread() is \
            threading.main_thread():
        seen["recode_s"] += time.perf_counter() - t0
        seen["recode_calls"] += 1
    return r
def decode(*a, **k):
    st = k.setdefault("stats", {})
    r = dec(*a, **k)
    seen["fallback_lanes"] = st.get("fallback_lanes")
    seen["decode_phases"] = st.get("phase_seconds")
    return r
em.encode, dm.decode, em.rt.encode_precomputed_colmajor = \
    encode, decode, recode
t1 = time.perf_counter()
rc = cli.main(["qvz_tpu_torch", *sys.argv[1:]])
secs = time.perf_counter() - t1
print(json.dumps({"rc": rc, "init_s": t1 - t, "secs": secs,
                  "launches": dict(_build.LAUNCHES),
                  "peak": torch.cuda.max_memory_allocated(),
                  "base_kb": base, "hwm_kb": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss, "seen": seen}))
"""

STREAM_BLOCKS = 11           # phase 17: 11 x 1,000,000 reads x 100 columns
STREAM_SHARDS = 512


def _child(args, env_extra, timeout=600) -> tuple[dict, list]:
    """Run STREAM_CHILD with the CLI's arguments from the repository root;
    returns its JSON line and the lines before it."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k != "QVZ_TPU_STREAM_MIN_BYTES"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    # A child of a shell that goes on after it (no exec), so that its
    # ru_maxrss starts from the shell's few MB: a child forked from this
    # process starts from this process's resident set, and the card's
    # machine has no VmHWM in /proc/self/status.
    r = subprocess.run(["/bin/sh", "-c", '"$0" "$@"; r=$?; exit $r',
                        sys.executable, "-c", STREAM_CHILD, *args], cwd=root,
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    lines = r.stdout.strip().splitlines()
    require(r.returncode == 0 and lines,
            f"child {args} exited {r.returncode}: {r.stdout[-2000:]}"
            f"{r.stderr[-2000:]}")
    res = json.loads(lines[-1])
    require(res["rc"] == 0, f"child {args}: cli.main returned {res['rc']}: "
            f"{lines[:-1]}")
    return res, lines[:-1]


def _s_fields(lines) -> tuple:
    """The -s line's rate, distortion and size."""
    f = [x.strip() for x in lines[-1].split(",")]
    require(f[0] == "rate" and f[6] == "size", f"an -s line: {lines}")
    return f[1], f[3], f[7]


def same_file(a: str, b: str) -> bool:
    import filecmp
    return filecmp.cmp(a, b, shallow=False)


def streamed_shards_k1(torch, np, src: str, qpath: str, n: int, cols: int,
                       gpu) -> dict:
    """K1 against its plain version at the shapes the streamed encode
    gives it: the warmup shard, a full shard and the ragged last shard of
    the plan, rebuilt from the input file as encode_streaming builds them
    (the memmap's rows, the WELL draws from each shard's start state), on
    the tables of the streamed container's codebooks. The container's
    directory must hold the same plan. Returns the largest error."""
    from qvz_tpu_torch.format import container_v2
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline.host import _rows, shard_plan

    counts, states, offs, _ = shard_plan(n, cols, STREAM_SHARDS, True,
                                         WellState.debug())
    S = len(counts)
    with open(qpath, "rb") as f:
        prefix = f.read(8 << 20)
    hdr = container_v2.header_size()
    tables = rt.tables_from_blocks(prefix[hdr:], 1, cols)
    head = container_v2.parse(prefix, blocks_len=tables.consumed,
                              payload_limit=os.path.getsize(qpath))
    require([sh.lines for sh in head.shards] == [int(c) for c in counts]
            and all(sh.well_state == np.asarray(st, "<u4").tobytes()
                    for sh, st in zip(head.shards, states)),
            "the streamed container's directory holds the shard plan")
    mm = np.memmap(src, dtype=np.uint8, mode="r")
    errs = []
    for s in (0, 1, S - 1):
        lo, hi = int(offs[s]), int(offs[s + 1])
        rows = _rows(mm, cols, lo, hi)
        draws = rt.well_draws7(states[s], (hi - lo) * cols).reshape(
            hi - lo, cols)
        data_t = torch.from_numpy(rows).cuda().t().contiguous()
        draws_t = torch.from_numpy(draws).cuda().t().contiguous()
        res, _ = k1_phase(torch, tables, data_t, draws_t, None, gpu,
                          f"[17] shard {s} of {S},")
        errs.append(res["err"])
    del mm
    return {"err": max(errs)}


def stream_risk(np, qpath: str) -> dict:
    """The models at risk of a column-major container's lanes (its tables
    and its warmup shard's bank, as the encode and the decode plan them):
    their count, and the bytes of K2a's records (over all columns, and in
    the largest chunk of columns) and of K5's (the largest wave's lanes)."""
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.pipeline import decode as pdec

    comp = np.memmap(qpath, dtype=np.uint8, mode="r")
    head, tables = pdec._parse(comp)
    s0 = head.shards[0]
    _, bank = rt.decode_colmajor(tables, pdec._payload(comp, head, 0),
                                 s0.lines, pdec._well(s0), want_bank=True)
    lens = [s.lines for s in head.shards[1:]]
    W, L = len(lens), max(lens)
    risk = cd.risk_tables(cd.plan_to_torch(cd.LanePlan(tables, bank), "cpu"),
                          L)
    roff = risk["roff_h"]
    k = cd.chunk_columns(head.columns, W, L, risk["rec_max"])
    chunk = max(int(roff[min(c0 + k, head.columns)] - roff[c0])
                for c0 in range(0, head.columns, k))
    wave = max(len(w) for w in pdec._waves(head))
    del comp
    return {"models": risk["models"], "k2a_bytes": 8 * W * int(roff[-1]),
            "k2a_chunk_bytes": 8 * W * chunk, "chunk_columns": k,
            "k5_bytes": 8 * wave * risk["rec_max"]}


def streamed_clustered(np, data, containers, td: str) -> dict:
    """encode_streaming on the card at -c 3 -T 4 of phase 2's input at
    phase 10's shard count, in chunks of 300,000 reads (K3 on each
    chunk's slice of the cluster ids, K1 with ids on each shard):
    byte-equal to phase 10's primed container, K3 once a chunk and K1
    once a shard. Returns its launches and seconds."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline.encode import device_lane_count
    from qvz_tpu_torch.pipeline.streaming import encode_streaming

    n, cols = data.shape
    src, out = os.path.join(td, "in1"), os.path.join(td, "c3.q")
    with open(src, "wb") as f:
        f.write(np.concatenate(
            [data + 33, np.full((n, 1), 10, np.uint8)], 1).tobytes())
    chunk = 300_000
    _build.LAUNCHES.clear()
    t = time.perf_counter()
    st = encode_streaming(src, out, n_clusters=3, cluster_threshold=4.0,
                          shards=device_lane_count(n), chunk_lines=chunk,
                          well_state=WellState.debug(), device="cuda")
    secs = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    with open(out, "rb") as f:
        require(f.read() == containers["-c 3 prime=True"][0],
                "the streamed -c 3 encode on the card equals phase 10's "
                "primed container")
    require(launches.get("hist") == -(-n // chunk),
            f"K3 once a chunk of {chunk}: {launches}")
    require(launches.get("quantize") == st["shards"],
            f"K1 once a shard ({st['shards']}): {launches}")
    print(f"[17] encode_streaming on the card, -c 3 -T 4, {st['shards']} "
          f"shards, chunks of {chunk}: byte-equal to phase 10 in "
          f"{secs:.3f} s; launches {launches}", flush=True)
    return {"launches": launches, "secs": secs}


def write_stream_input(np, data, src: str) -> int:
    """Phase 17's input: STREAM_BLOCKS x 1,000,000 reads x 100 columns
    (1.111 GB) written to `src` in 1,000,000-read blocks of the phase-2
    generator with seeds 42 on (42's is `data`, phase 2's input, or made
    here where None; the others made four at a time). Returns its size."""
    from concurrent.futures import ThreadPoolExecutor

    n, cols = STREAM_BLOCKS * 1_000_000, 100
    t = time.perf_counter()

    def block(seed):
        q = data if seed == 42 and data is not None \
            else make_input(1_000_000, cols, seed)
        return np.concatenate(
            [q + 33, np.full((len(q), 1), 10, np.uint8)], 1).tobytes()

    with open(src, "wb") as f, ThreadPoolExecutor(4) as ex:
        for raw in ex.map(block, range(42, 42 + STREAM_BLOCKS)):
            f.write(raw)
    size = os.path.getsize(src)
    require(size == n * (cols + 1) and size >= 2 ** 30,
            f"the input is {size} B, at least 1 GiB")
    print(f"[17] wrote {n} x {cols} ({size} B) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return size


def streamed_phase(torch, np, data, containers, gpu) -> dict:
    """Phase 17: a streamed encode of more than 1 GiB. 11,000,000 x 100
    reads (1.111 GB) written in 1,000,000-read blocks of the phase-2
    generator with seeds 42-52 (42's is phase 2's `data`; the others
    made four at a time), then four child interpreters: A, the CLI at
    -f 0.5 --debug-seed --shards 512 -s, which streams by itself; B, the
    same with -u above a raised QVZ_TPU_STREAM_MIN_BYTES, the in-memory
    device encode; D, A with --streaming and -u; then C, -x of A's
    container on the card. A's container equals B's and D's, its -s
    figures theirs, C's text and D's -u file B's -u file; A and D
    launched K3 once a chunk and K1 once a shard; A's peak resident set
    is below B's by the input's size at least, its peak device memory
    below B's. K1 is held against
    its plain version at A's shard shapes (streamed_shards_k1), and the
    streamed -c 3 path on the card against phase 10
    (streamed_clustered). Returns the launches and the figures."""
    import shutil
    import tempfile

    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline.host import shard_plan

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    td = tempfile.mkdtemp(prefix="smoke17_", dir=os.path.join(root, "build"))
    try:
        n, cols = STREAM_BLOCKS * 1_000_000, 100
        src = os.path.join(td, "in")
        size = write_stream_input(np, data, src)
        common = ["-f", "0.5", "--debug-seed", "--shards",
                  str(STREAM_SHARDS), "-s", "-v"]
        p = {k: os.path.join(td, k)
             for k in ("A.q", "B.q", "B.u", "D.q", "D.u", "A.dec")}
        a, a_out = _child([*common, src, p["A.q"]], {})
        b, b_out = _child([*common, "-u", p["B.u"], src, p["B.q"]],
                          {"QVZ_TPU_STREAM_MIN_BYTES": str(size + 1)})
        d, d_out = _child([*common, "--streaming", "-u", p["D.u"], src,
                           p["D.q"]], {})
        c, _ = _child(["-x", p["A.q"], p["A.dec"]], {})
        shards = len(shard_plan(n, cols, STREAM_SHARDS, True,
                                WellState.debug())[0])
        require(same_file(p["A.q"], p["B.q"]),
                "the streamed container equals the in-memory one")
        require(same_file(p["A.q"], p["D.q"]),
                "the streamed container with -u equals the one without")
        sa, sb, sd = _s_fields(a_out), _s_fields(b_out), _s_fields(d_out)
        require(sa == sb == sd,
                f"-s rate, distortion and size equal ({sa}, {sb}, {sd})")
        require(same_file(p["A.dec"], p["B.u"]),
                "the device decode of the streamed container equals -u")
        require(same_file(p["D.u"], p["B.u"]),
                "the streamed -u file equals the in-memory one")
        for tag, r in (("A", a), ("D", d)):
            require(r["launches"].get("hist") == STREAM_BLOCKS,
                    f"{tag} launched K3 once a chunk: {r['launches']}")
            require(r["launches"].get("quantize") == shards,
                    f"{tag} launched K1 once a shard ({shards}): "
                    f"{r['launches']}")
        require(a["hwm_kb"] * 1024 + size <= b["hwm_kb"] * 1024,
                f"A's peak RSS {a['hwm_kb']} kB below B's {b['hwm_kb']} kB "
                "by the input's size")
        require(a["peak"] < b["peak"],
                f"A's peak device memory {a['peak']} below B's {b['peak']}")
        qsize = os.path.getsize(p["A.q"])
        mb = size / 1e6
        print(f"[17] {shards} shards: the streamed container ({qsize} B) "
              f"byte-equal to the in-memory encode's and to --streaming "
              f"-u's, -s equal ({sa}), the device decode and the streamed "
              f"-u file equal to the in-memory -u; A launched "
              f"{a['launches']}", flush=True)
        for tag, out in (("A", a_out), ("B", b_out), ("D", d_out)):
            # -v's phase lines: "  name: seconds" (cli.py)
            split = dict(line.strip().rstrip("s").split(": ")
                         for line in out if line.startswith("  "))
            print(f"[17] {tag}'s phases (s): {json.dumps(split)}", flush=True)
        runs = {"A": a, "B": b, "C": c, "D": d}
        for tag, r in (("A streamed encode", a),
                       ("B in-memory encode, -u", b),
                       ("D streamed encode, -u", d),
                       ("C device decode of A", c)):
            print(f"[17] {tag}: {r['secs']:.3f} s = {mb / r['secs']:.1f} "
                  f"MB/s (after {r['init_s']:.3f} s of CUDA context); peak "
                  f"device memory {r['peak'] / 2**20:.1f} MiB; peak RSS "
                  f"{r['hwm_kb'] / 2**10:.1f} MiB ({r['base_kb'] / 2**10:.1f}"
                  " MiB with the context up)", flush=True)
        # the lanes sent to the host: none
        seen_b, seen_c = b["seen"], c["seen"]
        require(seen_b["coder_fallback_lanes"] == 0
                and seen_b["recode_calls"] == 0,
                f"B codes every lane on the card: {seen_b}")
        require(seen_c["fallback_lanes"] == 0,
                f"C decodes every lane on the card: {seen_c}")
        risk = stream_risk(np, p["A.q"])
        print(f"[17] B: coder_fallback_lanes {seen_b['coder_fallback_lanes']}"
              f", {seen_b['recode_calls']} lanes re-coded on the host in "
              f"{seen_b['recode_s']:.3f} s; C: fallback_lanes "
              f"{seen_c['fallback_lanes']}, phases "
              f"{json.dumps(seen_c['decode_phases'])}; the plan has "
              f"{risk['models']} models at risk: K2a's records "
              f"{risk['k2a_bytes']} B over all columns, "
              f"{risk['k2a_chunk_bytes']} B in a chunk of "
              f"{risk['chunk_columns']} columns; K5's {risk['k5_bytes']} B",
              flush=True)
        k1 = streamed_shards_k1(torch, np, src, p["A.q"], n, cols, gpu)
        clus = streamed_clustered(np, data, containers, td)
        return {"launches": [r["launches"] for r in runs.values()]
                + [clus["launches"]],
                "secs": {k: r["secs"] for k, r in runs.items()},
                "peak": {k: r["peak"] for k, r in runs.items()},
                "hwm_kb": {k: r["hwm_kb"] for k, r in runs.items()},
                "mb": mb, "k1_err": k1["err"]}
    finally:
        shutil.rmtree(td, ignore_errors=True)


def multihost_phase(np, data, containers) -> dict:
    """Phase 18: multi-host on the card. Phase 2's input written to a
    file; encode_multihost at 2 hosts and the device lane count on the
    card, byte-equal to phase 5's primed -c 1 container, each in-memory
    worker launching K3; the CLI's --hosts 2 --streaming -c 3 -T 4 at that
    shard count, byte-equal to phase 10's primed container; and
    decode_multihost at 2 hosts of phase 5's container, byte-equal to the
    host decoder. Returns the workers' K3 launches."""
    import shutil
    import tempfile

    from qvz_tpu_torch import cli
    from qvz_tpu_torch.parallel import multihost
    from qvz_tpu_torch.pipeline import host
    from qvz_tpu_torch.pipeline.encode import device_lane_count
    from qvz_tpu_torch.ops.well import WellState

    root = os.path.dirname(os.path.abspath(__file__))
    td = tempfile.mkdtemp(prefix="smoke18_", dir=os.path.join(root, "build"))
    try:
        n, cols = data.shape
        shards = device_lane_count(n)
        src = os.path.join(td, "in")
        with open(src, "wb") as f:
            f.write(np.concatenate(
                [data + 33, np.full((n, 1), 10, np.uint8)], 1).tobytes())
        t = time.perf_counter()
        comp, st = multihost.encode_multihost(
            src, n_hosts=2, shards=shards, well_state=WellState.debug(),
            device="cuda")
        secs = time.perf_counter() - t
        require(comp == containers["-c 1 prime=True"][0],
                "the 2-host encode equals phase 5's primed container")
        k3 = st["worker_launches"]["hist"]
        # each in-memory worker counts its rows in one K3 call
        require(st["hosts"] == 2 and k3 == [1, 1],
                f"each of the 2 workers launched K3 once ({k3})")
        out = os.path.join(td, "s.q")
        t = time.perf_counter()
        rc = cli.main(["qvz_tpu_torch", "--hosts", "2", "--streaming", "-f",
                       "0.5", "-c", "3", "-T", "4", "--shards", str(shards),
                       "--debug-seed", src, out])
        s_secs = time.perf_counter() - t
        require(rc == 0, "--hosts 2 --streaming -c 3 -T 4 ran")
        with open(out, "rb") as f:
            require(f.read() == containers["-c 3 prime=True"][0],
                    "the 2-host streamed -c 3 encode equals phase 10's "
                    "primed container")
        cpath, dec = os.path.join(td, "c.q"), os.path.join(td, "c.dec")
        with open(cpath, "wb") as f:
            f.write(containers["-c 1 prime=True"][0])
        t = time.perf_counter()
        require(multihost.decode_multihost(cpath, dec, n_hosts=2) == n,
                "decode_multihost decoded every line")
        d_secs = time.perf_counter() - t
        with open(dec, "rb") as f:
            require(f.read() == host.decode(
                containers["-c 1 prime=True"][0]).tobytes(),
                "the 2-host decode equals the host decoder")
        print(f"[18] 2 hosts, {shards} shards: the encode on the card "
              f"byte-equal to phase 5 in {secs:.3f} s (K3 launches by the "
              f"workers {k3}; phases "
              f"{ {k: round(v, 4) for k, v in st.items() if k.endswith('_s')} }"
              f"); --streaming -c 3 -T 4 byte-equal to phase 10 in "
              f"{s_secs:.3f} s; decode_multihost byte-equal to the host "
              f"decoder in {d_secs:.3f} s", flush=True)
        return {"hist": k3}
    finally:
        shutil.rmtree(td, ignore_errors=True)


class CallLaunches:
    """Records the kernel launches of each call of some functions (module,
    name): the launches counted by _build.LAUNCHES between a call's start
    and end, one Counter a call, by function. A context manager that
    restores the functions after."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = {name: [] for _, name in targets}
        self.saved = []

    def __enter__(self):
        from qvz_tpu_torch import _build

        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                before = dict(_build.LAUNCHES)
                out = _fn(*a, **kw)
                self.calls[_name].append(
                    {k: v - before.get(k, 0)
                     for k, v in _build.LAUNCHES.items()
                     if v != before.get(k, 0)})
                return out

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def mesh_phase(torch, np, data, dist, containers, e2e, k4_iters) -> dict:
    """Phase 19: the multi-device encode with several blocks of reads on
    the one card. -c 3 -T 4 primed at phase 10's shard count over 4
    blocks, byte-equal to phase 10's primed container; -c 1 primed at
    --shards 0 over 2 blocks, byte-equal to phase 5's. Every block's K4
    steps, K3, KJ, K1, K2a, K2b and (-c 3) K2s launches are counted call
    by call; the -c 3 container decodes on the card (K5p, K5) to the host
    decoder's bytes.
    Returns the launches, the kernels' under their _build names."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.ops import coder_device, kmeans, quantize, well_jump
    from qvz_tpu_torch.ops import stats as ts
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.parallel.mesh import make_mesh
    from qvz_tpu_torch.pipeline import decode as port_dec
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host

    n, cols = data.shape
    mb = n * (cols + 1) / 1e6
    launches = {}
    cases = (("-c 3 prime=True", 4,
              dict(n_clusters=3, cluster_threshold=4.0,
                   shards=port.device_lane_count(n))),
             ("-c 1 prime=True", 2, dict(shards=0)))
    for name, blocks, kw in cases:
        mesh = make_mesh(devices=["cuda:0"] * blocks)
        _build.LAUNCHES.clear()
        with CallLaunches([(kmeans, "_step_packed"),
                           (ts, "conditional_counts_t"),
                           (quantize, "quantize_t_device"),
                           (well_jump, "states_t"),
                           (coder_device, "code_lanes")]) as rec:
            t = time.perf_counter()
            out = port.encode(data, dist, well_state=WellState.debug(),
                              want_recon=False, prime=True, mesh=mesh, **kw)
            secs = time.perf_counter() - t
        for k, v in _build.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        require(out.compressed == containers[name][0],
                f"[19] {name} over {blocks} blocks: byte-equal to the "
                "one-device container")
        steps = k4_iters if kw.get("n_clusters", 1) > 1 else 0
        per = {"kmeans": ("_step_packed", blocks * steps),
               "hist": ("conditional_counts_t", blocks),
               "quantize": ("quantize_t_device", blocks),
               "well_jump": ("states_t", blocks),
               "coder_triples": ("code_lanes", blocks),
               "coder_chain": ("code_lanes", blocks)}
        if steps:
            per["coder_segment"] = ("code_lanes", blocks)
        for kernel, (fn, calls) in per.items():
            got = [c.get(kernel, 0) for c in rec.calls[fn]]
            require(len(got) == calls and all(g >= 1 for g in got),
                    f"[19] {name}: {kernel} launched in each of the "
                    f"{calls} calls of {fn} ({got})")
        phases = {k: round(v, 6) for k, v in out.stats.phase_seconds.items()}
        print(f"[19] {name} over make_mesh(devices=['cuda:0'] * {blocks}): "
              f"byte-equal to the one-device container in {secs:.4f} s = "
              f"{mb / secs:.1f} MB/s, one run (the one-device median "
              f"{e2e[name]:.4f} s); launches by call: "
              + "; ".join(f"{fn} {rec.calls[fn]}" for fn in rec.calls)
              + f"; phases {json.dumps(phases)}; a check of correctness on "
              "one card, not a multi-GPU measurement", flush=True)
        if name.startswith("-c 3"):
            _build.LAUNCHES.clear()
            st = {}
            got = port_dec.decode(out.compressed, device="cuda", stats=st)
            for k in ("cluster_prologue", "decoder"):
                launches[k] = launches.get(k, 0) + _build.LAUNCHES[k]
            require(_build.LAUNCHES["decoder"] >= 1
                    and st["fallback_lanes"] == 0
                    and np.array_equal(got, host.decode(out.compressed)),
                    "[19] the -c 3 mesh container decodes on the card (K5) "
                    "to the host decoder's bytes")
            print(f"[19] its decode on the card: byte-equal to the host "
                  f"decoder, {st['lanes']} lanes, 0 flagged, decoder "
                  f"launches {_build.LAUNCHES['decoder']}", flush=True)
    return launches


# A child interpreter of phase 20 (and of scripts/mesh_check_torch.py):
# one rank of a process group over the backend argv[5], on its own card
# (``distributed.initialize`` picks it), K3 over its share of the reads
# with their k-means ids and one all-reduce; prints its card, its K3
# launches and the sha256 of the counts and of the codebook blocks
# designed from them.
DIST_CHILD = r"""
import hashlib, json, sys
import numpy as np
sys.path.insert(0, sys.argv[6])
rank, world, port, src, backend = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
from qvz_tpu_torch import _build
from qvz_tpu_torch.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.parallel import distributed
data = np.load(src + ".data.npy", mmap_mode="r")
ids = np.load(src + ".ids.npy", mmap_mode="r")
lo, hi = rank * len(data) // world, (rank + 1) * len(data) // world
distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                       backend=backend, device="cuda")
c0, cond = distributed.distributed_conditional_counts(data[lo:hi],
                                                      ids[lo:hi], 3)
import torch.distributed
torch.distributed.destroy_process_group()
blocks = rt.Design(c0, cond, MODE_RATIO, 0.5,
                   make_matrix(DISTORTION_MSE)).serialized()
print(json.dumps({"rank": rank, "rows": hi - lo,
                  "device": str(distributed.rank_device()),
                  "hist": _build.LAUNCHES["hist"],
                  "c0": hashlib.sha256(c0.tobytes()).hexdigest(),
                  "cond": hashlib.sha256(cond.tobytes()).hexdigest(),
                  "blocks": hashlib.sha256(blocks).hexdigest()}))
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(np, data, ids, counts, dist, world: int, backend: str,
              cards: int, tag: str) -> dict:
    """`world` DIST_CHILD interpreters over `backend`, each with an even
    share of the reads and their k-means ids: every rank must get
    `counts`, the (counts0, cond) of all the reads, design the same
    codebook blocks, launch K3 once and run on card rank % cards. Returns
    the ranks' seconds with their start, rows and K3 launches."""
    import hashlib
    import shutil
    import tempfile

    from qvz_tpu_torch.constants import MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt

    root = os.path.dirname(os.path.abspath(__file__))
    c0, cond = counts
    want = {"c0": hashlib.sha256(c0.tobytes()).hexdigest(),
            "cond": hashlib.sha256(cond.tobytes()).hexdigest(),
            "blocks": hashlib.sha256(rt.Design(
                c0, cond, MODE_RATIO, 0.5, dist).serialized()).hexdigest()}
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    td = tempfile.mkdtemp(prefix="ranks_", dir=os.path.join(root, "build"))
    t = time.perf_counter()
    try:
        src = os.path.join(td, "in")
        np.save(src + ".data.npy", data)
        np.save(src + ".ids.npy", ids)
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-c", DIST_CHILD, str(r), str(world), port, src,
             backend, root], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                require(p.returncode == 0, f"{tag} a {backend} rank ran: "
                        f"{err[-3000:]}")
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        shutil.rmtree(td, ignore_errors=True)
    secs = time.perf_counter() - t
    for o in outs:
        require({k: o[k] for k in want} == want,
                f"{tag} {backend} rank {o['rank']} ({o['rows']} rows): "
                "counts and codebook blocks of all the reads")
        require(o["hist"] == 1, f"{tag} rank {o['rank']} launched K3 once")
        require(o["device"] == f"cuda:{o['rank'] % cards}",
                f"{tag} rank {o['rank']} ran on its own card "
                f"({o['device']})")
    print(f"{tag} {world} ranks over {backend}: counts and codebook blocks "
          f"of all the reads (sha256 c0 {want['c0'][:16]}, cond "
          f"{want['cond'][:16]}, blocks {want['blocks'][:16]} in every "
          f"rank), K3 once a rank, cards {[o['device'] for o in outs]}, "
          f"{secs:.3f} s with the children's start", flush=True)
    return {"seconds": secs, "rows": [o["rows"] for o in outs],
            "hist": sum(o["hist"] for o in outs)}


def distributed_phase(np, data, ids, counts, dist) -> dict:
    """Phase 20: two child interpreters over Gloo on the one card, each
    with half of the reads and their k-means ids: both get `counts`
    (phase 8's) and design the same codebook blocks; then world size 1
    over NCCL in this process. Returns the K3 launches."""
    import torch.distributed as tdist

    from qvz_tpu_torch import _build
    from qvz_tpu_torch.parallel import distributed

    c0, cond = counts
    ranks = run_ranks(np, data, ids, counts, dist, 2, "gloo", 1, "[20]")
    _build.LAUNCHES.clear()
    t1 = time.perf_counter()
    distributed.initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                           backend="nccl", device="cuda")
    try:
        got = distributed.distributed_conditional_counts(data, ids, 3)
    finally:
        tdist.destroy_process_group()
    nccl_secs = time.perf_counter() - t1
    require(np.array_equal(got[0], c0) and np.array_equal(got[1], cond)
            and _build.LAUNCHES["hist"] == 1,
            "[20] world size 1 over NCCL: the same counts, K3 once")
    print(f"[20] world size 1 over NCCL equal in {nccl_secs:.3f} s",
          flush=True)
    return {"hist": ranks["hist"] + 1}


def tools_phase(np, data, dist, containers, distortion: float) -> None:
    """Phase 21: the host tools on the card's machine. Phase 5's primed
    container transcoded to v1, byte-equal to the port's --shards 1
    encode of the input, and back to QVZ2 at the device lane count,
    byte-equal to phase 5's container; python -m
    qvz_tpu_torch.tools.mse_check of the decoded text against phase 5's
    -u reconstruction (0) and of the input against it (phase 5's -s
    distortion)."""
    import shutil
    import tempfile

    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import host
    from qvz_tpu_torch.tools import transcode

    root = os.path.dirname(os.path.abspath(__file__))
    n, cols = data.shape
    comp, recon = containers["-c 1 prime=True"]
    td = tempfile.mkdtemp(prefix="smoke21_", dir=os.path.join(root, "build"))
    try:
        p2, p1, back = (os.path.join(td, f) for f in ("p5.q", "v1.q",
                                                      "back.q"))
        with open(p2, "wb") as f:
            f.write(comp)
        t = time.perf_counter()
        transcode.transcode(p2, p1, "v1")
        to_v1 = time.perf_counter() - t
        t = time.perf_counter()
        v1 = host.encode(data, dist, well_state=WellState.debug(), shards=1,
                         want_recon=False).compressed
        direct = time.perf_counter() - t
        with open(p1, "rb") as f:
            require(f.read() == v1, "[21] phase 5's container transcoded to "
                    "v1 equals the port's --shards 1 encode")
        t = time.perf_counter()
        transcode.transcode(p1, back, "v2")
        to_v2 = time.perf_counter() - t
        with open(back, "rb") as f:
            require(f.read() == comp, "[21] the v1 container transcoded "
                    "back to QVZ2 at --shards 0 equals phase 5's")
        text = {"in": data + 33, "dec": host.decode(comp)[:, :cols],
                "u": recon + 33}
        for k, v in text.items():
            with open(os.path.join(td, k), "wb") as f:
                f.write(np.concatenate(
                    [v, np.full((n, 1), 10, np.uint8)], 1).tobytes())
        figures = {}
        for a in ("dec", "in"):
            r = subprocess.run(
                [sys.executable, "-m", "qvz_tpu_torch.tools.mse_check",
                 os.path.join(td, a), os.path.join(td, "u")], cwd=root,
                capture_output=True, text=True, timeout=300)
            require(r.returncode == 0, f"[21] mse_check ran: {r.stderr}")
            figures[a] = r.stdout.strip()
            fields = figures[a].split(", ")
            got = float(fields[fields.index("distortion") + 1])
            want = 0.0 if a == "dec" else distortion
            require(f"{got:.4f}" == f"{want:.4f}", f"[21] mse_check {a} "
                    f"against the -u file: {got} (want {want:.4f})")
        print(f"[21] transcode of phase 5's container to v1 in {to_v1:.3f} s"
              f", byte-equal to the --shards 1 encode ({direct:.3f} s); back"
              f" to QVZ2 at --shards 0 in {to_v2:.3f} s, byte-equal to phase"
              f" 5's; mse_check decoded vs -u: {figures['dec']}; input vs "
              f"-u: {figures['in']}", flush=True)
    finally:
        shutil.rmtree(td, ignore_errors=True)


# Phase 23's file: the benchmark cell's 10,000,000 reads of 100 columns
WELL_READS, WELL_COLS = 10_000_000, 100
# the WELL step's integer instructions (shifts and three-input logic
# operations of csrc/well.cu's words32), for KW's bound
WELL_STEP_OPS = 13


def device_ms(torch, fn, key: str, runs: int = 5) -> float:
    """The mean device time (ms) of the kernels named with `key` over
    `runs` calls of fn, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if key in e.key]
    total = sum((getattr(e, "device_time_total", None) or e.cuda_time_total)
                for e in evs)
    n = sum(e.count for e in evs)
    return total / 1e3 / n if n else float("nan")


def well_phase(torch, np, gpu) -> dict:
    """Phase 23: KW against the host's rt.well_draws7 on every shard of the
    10M x 100 plan and against its plain version on the card; its card
    time, device time, bound and the plain version's time; then KJ on the
    plan's streams against the host's chained jump and its plain
    version, the same figures."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.ops import well_draws as wd
    from qvz_tpu_torch.ops import well_jump as wj
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host
    from qvz_tpu_torch.roofline import ALU_LANES_PER_SM, bound

    n, cols = WELL_READS, WELL_COLS
    t = time.perf_counter()
    counts, states, _, prime_on = host.shard_plan(
        n, cols, port.device_lane_count(n), True, WellState.debug())
    chain_ms = (time.perf_counter() - t) * 1e3
    require(prime_on, "phase 23's plan primes")
    t = time.perf_counter()
    s_states, s_lines = wd.stream_plan(states, counts, cols)
    plan_ms = (time.perf_counter() - t) * 1e3
    jump = jump_check(torch, np, gpu, s_states, counts, cols,
                      chain_ms + plan_ms)
    dev = torch.device("cuda")
    words = torch.from_numpy(s_states.view(np.int32)).to(dev)
    uncut = torch.from_numpy(states.view(np.int32)).to(dev)
    out = {}
    before = _build.LAUNCHES["well_draws"]

    def kernel():
        out["k"] = wd.draws_t(words, s_lines, cols)

    def kernel_uncut():
        out["u"] = wd.draws_t(uncut, counts, cols)

    ms = statistics.median(event_ms(kernel, torch) for _ in range(6))
    dev_ms = device_ms(torch, kernel, "well_draws_kernel")
    uncut_ms = statistics.median(event_ms(kernel_uncut, torch)
                                 for _ in range(3))
    uncut_dev_ms = device_ms(torch, kernel_uncut, "well_draws_kernel", 2)
    launches = _build.LAUNCHES["well_draws"] - before
    got = out["k"]
    require(torch.equal(got, out.pop("u")),
            "[23] KW's draws from the cut streams equal those from the "
            "shards uncut")
    t = time.perf_counter()
    want = host._shard_draws(states, counts, cols)
    host_ms = (time.perf_counter() - t) * 1e3
    got_h = got.cpu().numpy()
    require(np.array_equal(got_h, want.T),
            "[23] KW's draws equal rt.well_draws7 on every shard")
    del want, got_h
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = wd.draws_t_reference(words, s_lines, cols)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(got, plain),
            "[23] KW's draws equal its plain version's on the card")
    del plain, got, out["k"]
    n_words = int(sum(-(-int(x) * cols // 4) for x in s_lines))
    nbytes = n * cols + s_states.nbytes + 8 * (len(s_lines) + 1)
    bnd = bound(nbytes, WELL_STEP_OPS * n_words, gpu.per_s(ALU_LANES_PER_SM))
    print(f"[23] KW, {len(counts)} shards ({len(s_lines)} streams, the "
          f"warmup shard of {counts[0]} lines in pieces of {counts[1]}) x "
          f"{cols} columns: equal to rt.well_draws7 on every shard and to "
          f"its plain version; kernel {ms:.4f} ms (median of 6, CUDA "
          f"events), device {dev_ms:.4f} ms (profiler, mean of 5); the "
          f"shards uncut {uncut_ms:.4f} ms, device {uncut_dev_ms:.4f} ms; "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}: {nbytes / 1e9:.4f} GB, "
          f"{n_words} words x {WELL_STEP_OPS} ops); plain {plain_ms:.1f} "
          f"ms (once); the host's _shard_draws {host_ms:.1f} ms; the "
          f"pieces' plan on the host {plan_ms:.2f} ms; launches {launches}",
          flush=True)
    return {"ms": ms, "device_ms": dev_ms, "uncut_ms": uncut_ms,
            "uncut_device_ms": uncut_dev_ms, "plain_ms": plain_ms,
            "host_ms": host_ms, "plan_ms": plan_ms, "bound": bnd,
            "launches": launches, "jump": jump}


def jump_check(torch, np, gpu, s_states, counts, cols, chain_ms) -> dict:
    """Phase 23's KJ: the start states of the plan's streams from their
    word offsets on the card, against the host chain's (s_states, which
    took chain_ms) and KJ's plain version on the card; its card time,
    device time and bound."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.ops import well_draws as wd
    from qvz_tpu_torch.ops import well_jump as wj
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import host
    from qvz_tpu_torch.roofline import ALU_LANES_PER_SM, bound

    dev = torch.device("cuda")
    v0 = host._state_words(WellState.debug())
    words, _, _ = wd.stream_offsets(counts, cols)
    out = {}
    before = _build.LAUNCHES["well_jump"]

    def kernel():
        out["j"] = wj.states_t(v0, words, dev)

    kernel()    # the table's upload, once a card
    ms = statistics.median(event_ms(kernel, torch) for _ in range(6))
    dev_ms = device_ms(torch, kernel, "well_jump_kernel")
    launches = _build.LAUNCHES["well_jump"] - before
    got = out.pop("j")
    require(np.array_equal(got.cpu().numpy().view(np.uint32), s_states),
            "[23] KJ's states equal the host chain's (rt.well_jump) on "
            "every stream")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = wj.states_t_reference(
        torch.from_numpy(v0.view(np.int32)).to(dev),
        torch.from_numpy(words).to(dev), wj.table_t(got.device))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(got, plain),
            "[23] KJ's states equal its plain version's on the card")
    # a product: 1,024 rows of 32 three-input AND-XORs and a parity
    products = sum(bin(int(w)).count("1") for w in words)
    ops = products * 1024 * (32 + 1)
    powers = bin(int(np.bitwise_or.reduce(words))).count("1")
    nbytes = powers * 1024 * 128 + 8 * len(words) + 128 * len(words)
    bnd = bound(nbytes, ops, gpu.per_s(ALU_LANES_PER_SM))
    print(f"[23] KJ, {len(words)} streams ({products} products of "
          f"{powers} powers of M): equal to the host chain's states on "
          f"every stream and to its plain version; kernel {ms:.4f} ms "
          f"(median of 6, CUDA events, the offsets' upload included), "
          f"device {dev_ms:.4f} ms (profiler, mean of 5); bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}: {ops / 1e9:.3f} G operations, "
          f"{nbytes / 1e6:.2f} MB); plain {plain_ms:.1f} ms (once); the "
          f"host chain (shard_plan, stream_plan) {chain_ms:.1f} ms; "
          f"launches {launches}", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "chain_ms": chain_ms, "bound": bnd, "launches": launches}


def sanitizer_phase() -> dict:
    """Phase 22 (see the module docstring): scripts/sanitize_torch.py
    --child none in a child interpreter, without the caching allocator as
    under the sanitizer. Returns the child's record."""
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scripts", "sanitize_torch.py"), "--child", "none"],
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTORCH_NO_CUDA_MEMORY_CACHING": "1"})
    secs = time.perf_counter() - t
    require(r.returncode == 0, f"[22] sanitize_torch.py --child none: "
            f"exit {r.returncode}: {(r.stdout + r.stderr)[-4000:]}")
    rec = json.loads(r.stdout.splitlines()[-1])
    for name in rec["kernels"]:
        require(rec["launches"].get(name, 0) > 0, f"[22] {name} launched")
    c = rec["corpus"]
    require(c["containers"] >= 40 and c["reached_k5"] > 0,
            "[22] the corpus reached K5")
    print(f"[22] every kernel of csrc/ in {len(rec['paths'])} code paths "
          f"equal to its plain version (launches {rec['launches']}); "
          f"corrupt corpus: {c['containers']} containers, {c['raised']} "
          f"raised and {c['decoded']} decoded as the host decoder, "
          f"{c['reached_k5']} through K5p and K5 ({c['flagged_lanes']} "
          f"lanes flagged and decoded again on the host; K5p equal to the "
          f"host's prologue on {c['prologue_lanes']} lanes, "
          f"{c['prologue_flagged']} flagged), {c['seconds']:.1f} s; "
          f"child {rec['seconds']:.1f} s of {secs:.1f} s", flush=True)
    print(f"[22] code paths: {'; '.join(rec['paths'])}", flush=True)
    return rec


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
    from qvz_tpu_torch.ops import stats as ts
    from qvz_tpu_torch.ops.distortion import make_matrix
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host
    from qvz_tpu_torch.roofline import (ALU_LANES_PER_SM, FMA_LANES_PER_SM,
                                        HBM_BYTES_PER_S, SHARED_WORDS_PER_SM)
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
    data_t = data_dev.t().contiguous()
    draws_t = torch.from_numpy(draws).to(dev).t().contiguous()
    k1, got = k1_phase(torch, tables, data_t, draws_t, None, gpu, "[3]")
    mid, qs, _ = got

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
    distortion = {}
    stats_phase = {}
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
        distortion[prime] = fast.stats.distortion
        stats_phase[prime] = fast.stats.phase_seconds["stats"]
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
    for name in ("hist", "quantize", "coder_triples", "coder_chain",
                 "well_draws", "well_jump"):
        require(launches.get(name, 0) >= 1, f"the encode launched {name}")
    # the encode's stats phase split as pipeline/encode.py runs it: K3
    # (CUDA events), then the counts' copy to the host (host clock)
    dt = data_dev.t().contiguous()
    split = []
    for _ in range(5):
        got = []
        k3_ms = event_ms(lambda: got.append(
            ts.conditional_counts_t(dt, None, 1)), torch)
        t = time.perf_counter()
        [x.cpu().numpy() for x in got[0]]
        split.append((k3_ms, (time.perf_counter() - t) * 1e3))
    del dt, got
    print(f"[5] the stats phase split (median of 5): K3 "
          f"{statistics.median(a for a, _ in split):.4f} ms (CUDA events), "
          f"the counts' copy to the host "
          f"{statistics.median(b for _, b in split):.4f} ms (host clock); "
          f"the encodes' stats phase (last run) "
          + ", ".join(f"prime={p} {v * 1e3:.4f} ms"
                      for p, v in stats_phase.items()), flush=True)

    # -- 6.-10. the clustered path (-c 3 -T 4) -----------------------------
    clus = clustered_phases(torch, np, data, dist, gpu)
    k3 = clus.pop("k3")
    for name, k in clus["launches"].items():
        launches[name] = launches.get(name, 0) + k
    containers.update(clus.pop("containers"))

    # -- 11.-13. the device decode -------------------------------------------
    dec = decode_phases(torch, np, containers, dist, gpu, k2)
    launches["decoder"] = dec["launches"]["decoder"]
    launches["cluster_prologue"] = dec["launches"]["cluster_prologue"]

    # -- 15. the integer-issue microbenchmark --------------------------------
    mb_kernels = microbench_phase()

    # -- 16. a plan too large for K5's shared-memory layout -----------------
    big = big_plan_phase(torch, np, dist, gpu)

    # -- 17. a streamed encode of more than 1 GiB ----------------------------
    torch.cuda.empty_cache()     # the card's memory for the children
    streamed = streamed_phase(torch, np, data, containers, gpu)
    # -- 18. multi-host on the card -----------------------------------------
    mh = multihost_phase(np, data, containers)
    for child in streamed["launches"]:
        for name, k in child.items():
            launches[name] = launches.get(name, 0) + k
    launches["hist"] += sum(mh["hist"])
    # -- 19. the multi-device encode, several blocks on the card ---------------
    mesh = mesh_phase(torch, np, data, dist, containers,
                      {"-c 1 prime=True": e2e[True],
                       "-c 3 prime=True": clus["e2e"][True]},
                      clus["k4_iters"])
    for name, k in mesh.items():
        launches[name] = launches.get(name, 0) + k
    # -- 20. torch.distributed ------------------------------------------------
    launches["hist"] += distributed_phase(np, data, clus["ids"],
                                          clus["counts8"], dist)["hist"]
    # -- 21. the tools --------------------------------------------------------
    tools_phase(np, data, dist, containers, distortion[True])
    # -- 22. every kernel's code paths and the corrupt corpus ---------------
    sanitizer_phase()
    # -- 23. KW on the 10M x 100 plan ----------------------------------------
    well = well_phase(torch, np, gpu)
    launches["well_draws"] += well["launches"]
    launches["well_jump"] = launches.get("well_jump", 0) \
        + well["jump"]["launches"]
    require("jax" not in sys.modules, "no JAX imported")

    kernels = [
        {"name": "quantize", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/quantize.cu",
         "replaces": "qvz_tpu/ops/quantize_pallas.py:292",
         "launches": launches["quantize"],
         "max_abs_err": max(k1["err"], clus["k1"]["err"], big["k1_err"],
                            streamed["k1_err"]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound"][0], "bound_by": k1["bound"][1],
         "library_ms": None},
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
         "launches": launches["hist"],
         "max_abs_err": max(k3["err"], big["k3"]["err"]),
         "ms": k3["ms"]["illumina C=3"],
         "plain_ms": k3["plain_ms"]["illumina C=3"],
         "bound_ms": k3["bound"][3][0], "bound_by": k3["bound"][3][1],
         "library_ms": k3["lib_ms"][3],
         "ms_c1": k3["ms"]["illumina C=1"],
         "plain_ms_c1": k3["plain_ms"]["illumina C=1"],
         "bound_ms_c1": k3["bound"][1][0], "library_ms_c1": k3["lib_ms"][1],
         "ms_binned_c1": k3["ms"]["binned C=1"],
         "ms_binned_c3": k3["ms"]["binned C=3"],
         "ms_c150": big["k3"]["ms"], "plain_ms_c150": big["k3"]["plain_ms"],
         "bound_ms_c150": big["k3"]["bound"][0],
         "zero_ms_c1": k3["zero_ms"][1], "zero_ms_c3": k3["zero_ms"][3]},
        {"name": "kmeans", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/kmeans.cu",
         "replaces": "qvz_tpu/ops/pallas_kernels.py:33",
         "launches": launches["kmeans"],
         "max_abs_err": max(clus["k4_err"], big["k4_err"]),
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
        # K2s and K5p have no TPU kernel: each replaces qvz_tpu's host step
        {"name": "coder_segment", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/coder.cu",
         "replaces": "qvz_tpu/pipeline/encode.py:360",
         "launches": launches["coder_segment"],
         "max_abs_err": max(clus["k2s"]["err"], big["k2s_err"]),
         "ms": clus["k2s"]["ms"], "plain_ms": clus["k2s"]["plain_ms"],
         "bound_ms": clus["k2s"]["bound"][0],
         "bound_by": clus["k2s"]["bound"][1], "library_ms": None},
        {"name": "cluster_prologue", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/decoder.cu",
         "replaces": "qvz_tpu/pipeline/decode.py:281",
         "launches": launches["cluster_prologue"],
         "max_abs_err": max([big["k5p_err"]] + [
             r["err"] for r in dec["k5p"].values()]),
         "ms": dec["k5p"]["-c 3 prime=True"]["ms"],
         "plain_ms": dec["k5p"]["-c 3 prime=True"]["plain_ms"],
         "bound_ms": dec["k5p"]["-c 3 prime=True"]["bound"][0],
         "bound_by": dec["k5p"]["-c 3 prime=True"]["bound"][1],
         "library_ms": None},
        # KW replaces the host's fill of the draws (rt.well_draws7)
        {"name": "well_draws", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/well.cu",
         "replaces": "qvz_tpu_torch/pipeline/host.py:144",
         "launches": launches["well_draws"], "max_abs_err": 0,
         "ms": well["ms"], "device_ms": well["device_ms"],
         "plain_ms": well["plain_ms"], "bound_ms": well["bound"][0],
         "bound_by": well["bound"][1], "library_ms": None},
        # KJ replaces the host's chained jump-ahead (rt.well_jump)
        {"name": "well_jump", "route": "cuda",
         "source": "qvz_tpu_torch/csrc/well_jump.cu",
         "replaces": "qvz_tpu_torch/pipeline/host.py:122",
         "launches": launches["well_jump"], "max_abs_err": 0,
         "ms": well["jump"]["ms"], "device_ms": well["jump"]["device_ms"],
         "plain_ms": well["jump"]["plain_ms"],
         "bound_ms": well["jump"]["bound"][0],
         "bound_by": well["jump"]["bound"][1], "library_ms": None},
        *mb_kernels,
    ]
    for k in kernels:
        require(k["ms"] >= k["bound_ms"],
                f"{k['name']} ({k['ms']} ms) no faster than its bound")
    hist = next(k for k in kernels if k["name"] == "hist")
    for case in ("c1", "c150"):
        require(hist[f"ms_{case}"] >= hist[f"bound_ms_{case}"],
                f"hist at {case} ({hist[f'ms_{case}']} ms) no faster than "
                "its bound")
    print(f"e2e encode MB/s: -c 1 prime on {mb / e2e[True]:.1f}, "
          f"prime off {mb / e2e[False]:.1f}; -c 3 prime on "
          f"{mb / clus['e2e'][True]:.1f}, prime off "
          f"{mb / clus['e2e'][False]:.1f}")
    print("e2e decode MB/s (host decoder): " + "; ".join(
        f"{name} {mb / s:.1f} ({mb / h:.1f})"
        for name, (s, h) in dec["e2e"].items()))
    sm = streamed["mb"]
    print(f"phase 17, {sm:.0f} MB: streamed encode {sm / streamed['secs']['A']:.1f}"
          f" MB/s, in-memory encode with -u {sm / streamed['secs']['B']:.1f}, "
          f"streamed encode with -u {sm / streamed['secs']['D']:.1f}, "
          f"device decode {sm / streamed['secs']['C']:.1f} (each a child "
          "interpreter's cli.main); peak device memory MiB "
          + ", ".join(f"{k} {v / 2**20:.1f}" for k, v in streamed["peak"].items())
          + "; peak RSS MiB "
          + ", ".join(f"{k} {v / 2**10:.1f}"
                      for k, v in streamed["hwm_kb"].items()))
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
