#!/usr/bin/env python3
"""compute-sanitizer over every CUDA kernel of qvz_tpu_torch, on the card.

    python3 scripts/sanitize_torch.py

From the repository root of a machine with an NVIDIA GPU, it finds
compute-sanitizer (beside nvcc, or on PATH), builds the kernels' line-info
library (``_build.load(lineinfo=True)``: the same code, with source lines
in the reports) and runs the workload below in four child interpreters,
one under each tool: memcheck, racecheck, synccheck and initcheck. Each
child runs with ``--error-exitcode 99``, a kernel filter on the port's
kernel names (PyTorch's kernels are not under test) and
PYTORCH_NO_CUDA_MEMORY_CACHING=1, so that memcheck sees each tensor's own
allocation rather than a slice of the caching allocator's pool. For each
tool it prints the kernels checked, their launches, the tool's errors and
the child's seconds; any error, a missing launch or a kernel unequal to
its plain version exits 1. Where compute-sanitizer is missing, or refuses
the card (it does inside a gVisor sandbox: "Device not supported"), the
script raises with the tool's own message before any child runs.

    python3 scripts/sanitize_torch.py --child TOOL

runs the workload in this process: TOOL names the tool it runs under, or
``none`` to run it without one (chip_smoke.py's phase 22). It launches
every kernel in ``qvz_tpu_torch/csrc/`` at small shapes that take each of
its code paths, and holds each output equal to its plain version, run on
the CPU:

  K1  quantize_kernel: -c 1 and -c 3;
  K2a triples_kernel: layouts 0, 1 and 2, each forced, without records and
      with the records of models that rescale (chip_smoke.rescale_case at
      8 lanes of 600 reads);
  K2b chain_kernel: the column chain, with the cluster-id segment at -c 3,
      through rescales, and at pending runs of 31 to 100 bits
      (chip_smoke.pending_runs);
  K2s segment_kernel: the cluster-id segment's triples at -c 3 (and
      through model 0's rescale in the rescale case), also against the
      host's rt.replay_model;
  K3  hist_kernel: mode 0 (counters in shared memory, C <= 11) at C = 1
      and 3, mode 1 (in device memory) at C = 40;
  K4  kmeans_kernel: sums in registers (K = 3), in shared memory (K = 150)
      and in device memory (K = 255 at 1,022 columns), each block walking
      three or more tiles so that the cp.async double buffer turns over;
  K5  decode_lanes_kernel and text_rows_kernel: layouts 0, 1 and 2,
      primed and unprimed containers, and with the records of models that
      rescale;
  K5p cluster_prologue_kernel: -c 1 (the start states) and -c 3 (the
      ids), also against the host's rt.decode_cluster_prologue, through
      model 0's rescale in the rescale case, and on lanes it flags (banks
      whose model 0 total is not its counts' sum);
  KW  well_draws_kernel: columns a multiple of 4 and not, 16-byte, 4-byte
      and single-byte stores, a warmup shard in pieces, fewer streams a
      block at 1,000 columns, 4-line tiles at 14,600 columns and one-line
      tiles in chunks of columns at 60,000 and 60,001;
  KJ  well_jump_kernel: the streams of those plans, from the stream
      offsets, groups of one to many streams a block, offsets of 0 and
      past 2^32 words;
  the microbenchmark's issue (addxor, cmpsel), mix (3-D and 2-D) and
  selmix (sel, sel_b4, sweeponly);
  the encode and decode on the card at -c 1 primed and -c 3 unprimed,
  byte-equal to the port's host engine.

Under memcheck (and with ``none``) it also decodes the corrupt-container
corpus (``corpus``): 52 column-major QVZ2 containers of 20,000 x
50 with lanes, cut, flipped, cut short under recomputed checksums, with
lying directories, each decoded with device="cuda" and held to the port's
host decoder's outcome (both raise ValueError, or both return the same
bytes), with K5p and K5 launched for every container whose header,
directory, checksums and warmup shard pass, and K5p's ids, states and
flags there equal to the host's cluster-id prologue lane by lane. The
child's last line is one JSON object of what it ran.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import make_input, prologue_check, require  # noqa: E402
from qvz_tpu_torch.format import container_v2  # noqa: E402

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# the mangled names of the kernels in qvz_tpu_torch/csrc/
KERNEL_REGEX = (r"(quantize|triples|chain|segment|hist|kmeans|decode_lanes|"
                r"text_rows|cluster_prologue|well_draws|well_jump)_kernel|"
                r"qvz_mb_")
KERNELS = ("quantize", "coder_triples", "coder_chain", "coder_segment",
           "hist", "kmeans", "decoder", "cluster_prologue", "well_draws",
           "well_jump", "issue", "mix", "selmix")
# the workload's shape: lanes of 125 lines keep the plain K2 and K5 short
N, COLS, SHARDS = 4001, 20, 32
CORPUS_SHAPE = (20_000, 50)


# -- the corrupt-container corpus -------------------------------------------

def _dir_start(head) -> int:
    return container_v2.header_size() + len(head.blocks) + 128


def _rebuild(blob: bytes, head, lines=None, states=None,
             payloads=None) -> bytes:
    """`blob` with its shards' lines, WELL states or payloads replaced;
    each directory entry gets its payload's length and a checksum
    recomputed over it."""
    from qvz_tpu_torch.native import runtime as rt
    sh = head.shards
    lines = lines or [s.lines for s in sh]
    states = states or [bytes(s.well_state) for s in sh]
    pays = payloads or [blob[s.payload_off:s.payload_off + s.payload_len]
                        for s in sh]
    out = bytearray(blob[:_dir_start(head)])
    for nl, st, pay in zip(lines, states, pays):
        out += container_v2.dir_entry(nl, len(pay), rt.xxh64(bytes(pay)),
                                      st)
    for pay in pays:
        out += pay
    return bytes(out)


def _flip(blob: bytes, pos: int, bit: int) -> bytes:
    b = bytearray(blob)
    b[pos] ^= 1 << bit
    return bytes(b)


# the corpus's base containers (clusters, shards, priming) and the ways
# each is corrupted
BASES = ((1, 8, True), (1, 4, False), (3, 4, False), (3, 8, True))
KINDS = ("cut-header", "cut-blocks", "cut-directory", "cut-payload",
         "flip-payload", "flip-rechecked-1", "flip-rechecked-8",
         "short-rechecked", "flip-state", "move-lines", "flip-blocks",
         "fuzz-header", "flip-shard0-rechecked")


def corpus_names() -> list:
    """The names of ``corpus``'s containers, in its order."""
    return [f"c{k}-s{s}-{'primed' if p else 'unprimed'}:{kind}"
            for k, s, p in BASES for kind in KINDS]


def corpus(n: int = CORPUS_SHAPE[0], cols: int = CORPUS_SHAPE[1],
           seed: int = 12) -> list:
    """[(name, container bytes)]: the four column-major QVZ2 containers
    with lanes of BASES (n x cols of the verify recipe's generator, -f
    0.5, MSE, the debug WELL seed, -T 4), each corrupted in the ways of
    KINDS, fixed by `seed`: cut in the header, the codebook blocks, the
    directory and the payloads; a payload bit flipped; a lane's payload
    bits flipped under a recomputed checksum (one and eight); a lane's
    payload cut to half under a recomputed checksum; a lane's WELL state
    flipped; lines moved between the first and the last lane (the total
    kept); a codebook bit flipped; a header byte set at random; and four
    bits of shard 0's payload flipped under a recomputed checksum (the
    warmup shard where primed)."""
    from qvz_tpu_torch.constants import DISTORTION_MSE
    from qvz_tpu_torch.ops.distortion import make_matrix
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import decode as pdec
    from qvz_tpu_torch.pipeline import host

    data = make_input(n, cols, seed)
    dist = make_matrix(DISTORTION_MSE)
    rng = np.random.default_rng(seed)
    out = []
    for k, shards, prime in BASES:
        base = host.encode(data, dist, n_clusters=k,
                           well_state=WellState.debug(), shards=shards,
                           prime=prime, want_recon=False).compressed
        head = pdec._parse(base)[0]
        sh = head.shards
        first = 1 if head.priming else 0
        pays = [base[s.payload_off:s.payload_off + s.payload_len]
                for s in sh]
        hdr = _dir_start(head) - 128 - len(head.blocks)
        d0 = _dir_start(head)

        def lane():
            return int(rng.integers(first, len(sh)))

        def with_pay(i, pay):
            return _rebuild(base, head, payloads=pays[:i] + [pay]
                            + pays[i + 1:])

        def flipped(i, nflips):
            p = bytearray(pays[i])
            for _ in range(nflips):
                p[int(rng.integers(0, len(p)))] ^= 1 << int(rng.integers(8))
            return with_pay(i, bytes(p))

        i = lane()
        states = [bytearray(s.well_state) for s in sh]
        states[lane()][int(rng.integers(0, 128))] ^= 0xFF
        lines = [s.lines for s in sh]
        moved = int(rng.integers(1, lines[-1]))
        lines[first], lines[-1] = lines[first] + moved, lines[-1] - moved
        fuzz = bytearray(base)
        fuzz[int(rng.integers(0, hdr))] = int(rng.integers(0, 256))
        cases = {
            "cut-header": base[:int(rng.integers(1, hdr))],
            "cut-blocks": base[:hdr + int(rng.integers(1, len(head.blocks)))],
            "cut-directory": base[:d0 + int(rng.integers(
                1, len(sh) * container_v2.DIR_ENTRY_SIZE))],
            "cut-payload": base[:len(base) - int(rng.integers(
                1, sh[-1].payload_len + 1))],
            "flip-payload": _flip(base, sh[i].payload_off + int(
                rng.integers(0, sh[i].payload_len)), int(rng.integers(8))),
            "flip-rechecked-1": flipped(lane(), 1),
            "flip-rechecked-8": flipped(lane(), 8),
            "short-rechecked": with_pay(i, pays[i][:len(pays[i]) // 2]),
            "flip-state": _rebuild(base, head,
                                   states=[bytes(s) for s in states]),
            "move-lines": _rebuild(base, head, lines=lines),
            "flip-blocks": _flip(base, hdr + int(rng.integers(
                0, len(head.blocks))), int(rng.integers(8))),
            "fuzz-header": bytes(fuzz),
            "flip-shard0-rechecked": flipped(0, 4),
        }
        tag = f"c{k}-s{shards}-{'primed' if prime else 'unprimed'}"
        out += [(f"{tag}:{kind}", cases[kind]) for kind in KINDS]
    return out


def outcome(fn):
    """("ok", result) or ("ValueError", message); any other exception
    propagates."""
    try:
        return "ok", fn()
    except ValueError as e:
        return "ValueError", str(e)


def check_corpus(blobs) -> dict:
    """Each corrupt container decoded with device="cuda", against the
    port's host decoder: the same outcome, the checksum message where the
    host gives one, and K5p and K5 launched exactly where prepare_lanes
    passes on the host (header, directory, checksums and warmup), K5p
    there equal to the host's prologue lane by lane (prologue_check)."""
    from qvz_tpu_torch import _build
    from qvz_tpu_torch.pipeline import decode as pdec
    from qvz_tpu_torch.pipeline import host

    res = {"containers": len(blobs), "raised": 0, "decoded": 0,
           "reached_k5": 0, "flagged_lanes": 0, "prologue_lanes": 0,
           "prologue_flagged": 0}
    for name, blob in blobs:
        want = outcome(lambda: host.decode(blob))
        reaches = outcome(lambda: pdec.prepare_lanes(blob, "cpu"))[0] == "ok"
        before = _build.LAUNCHES["decoder"]
        before_p = _build.LAUNCHES["cluster_prologue"]
        st: dict = {}
        got = outcome(lambda: pdec.decode(blob, device="cuda", stats=st))
        launched = _build.LAUNCHES["decoder"] - before
        require((_build.LAUNCHES["cluster_prologue"] - before_p > 0)
                == reaches, f"corpus {name}: K5p launched where the host "
                "stages pass")
        if reaches:
            lanes = pdec.prepare_lanes(blob, "cuda")
            res["prologue_flagged"] += prologue_check(blob, lanes,
                                                      f"corpus {name}")
            res["prologue_lanes"] += len(lanes.lane_counts)
        require(got[0] == want[0], f"corpus {name}: the card's outcome "
                f"{got[0]} ({got[1] if got[0] != 'ok' else ''}) is the host "
                f"decoder's {want[0]} ({want[1] if want[0] != 'ok' else ''})")
        if want[0] == "ok":
            require(np.array_equal(got[1], want[1]),
                    f"corpus {name}: the card's bytes are the host's")
            res["decoded"] += 1
        else:
            require("checksum" not in want[1] or "checksum" in got[1],
                    f"corpus {name}: the checksum error ({got[1]})")
            res["raised"] += 1
        require((launched > 0) == reaches, f"corpus {name}: K5 launched "
                f"{launched} times, host stages {'pass' if reaches else 'fail'}")
        res["reached_k5"] += reaches
        res["flagged_lanes"] += st.get("fallback_lanes", 0)
    return res


# -- every kernel's code paths against the plain versions -------------------

def _equal(name: str, got, want) -> None:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    require(len(got) == len(want) and all(
        a.shape == b.shape and bool((a.cpu() == b.cpu()).all())
        for a, b in zip(got, want)), f"{name} equals its plain version")


def _stats_quantize_code(torch, dev, paths: list) -> None:
    """K3, K1, K2a (three layouts), K2b and K5 (three layouts) at -c 1
    primed and -c 3 unprimed, and the encode and decode on the card."""
    from qvz_tpu_torch.constants import DISTORTION_MSE, MODE_RATIO
    from qvz_tpu_torch.native import runtime as rt
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import decoder_device as dd
    from qvz_tpu_torch.ops import quantize as tq
    from qvz_tpu_torch.ops import stats as ts
    from qvz_tpu_torch.ops.distortion import make_matrix
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import decode as pdec
    from qvz_tpu_torch.pipeline import encode as port
    from qvz_tpu_torch.pipeline import host

    cpu = torch.device("cpu")
    data = make_input(N, COLS, 42)
    dist = make_matrix(DISTORTION_MSE)
    data_t = torch.from_numpy(np.ascontiguousarray(data.T))
    for k, prime in ((1, True), (3, False)):
        tag = f"-c {k} {'primed' if prime else 'unprimed'}"
        ids = rt.kmeans_host(data, k, 4.0)[0] if k > 1 else None
        ids_t = torch.from_numpy(ids) if ids is not None else None

        def on(x):
            return x.to(dev) if x is not None else None

        shape = ts.card_hist_shape(on(data_t), k)
        _equal(f"K3 {tag} (mode {shape['mode']})",
               ts.conditional_counts_t(on(data_t), on(ids_t), k),
               ts.conditional_counts_reference(data_t, ids_t, k))
        paths.append(f"K3 mode {shape['mode']} C={k}")
        c0, cond = rt.stats_host(data, ids, k)
        tables = rt.Design(c0, cond, MODE_RATIO, 0.5, dist).tables()

        counts, states, offs, prime_on = host.shard_plan(
            N, COLS, SHARDS, prime, WellState.debug())
        draws_t = torch.from_numpy(np.ascontiguousarray(
            host._shard_draws(states, counts, COLS).T))
        got = tq.quantize_t_device(tq.tables_to_torch(tables, dev),
                                   on(data_t), on(draws_t), on(ids_t))
        want = tq.quantize_reference(tq.tables_to_torch(tables, cpu), data_t,
                                     draws_t, ids_t)
        _equal(f"K1 {tag}", got, want)
        paths.append(f"K1 C={k}")
        mid, qs, _ = want

        first = 1 if prime_on else 0
        bank = None
        if prime_on:
            w = int(counts[0])
            md0, qs0, _, _ = rt.quantize_colmajor(
                tables, np.ascontiguousarray(data[:w].T),
                ids[:w] if ids is not None else None, states[0])
            bank = rt.bank_from_stream(tables, md0, qs0,
                                       ids[:w] if ids is not None else None,
                                       w)
        plan = cd.LanePlan(tables, bank)
        plan_c, plan_d = cd.plan_to_torch(plan, cpu), cd.plan_to_torch(
            plan, dev)
        lanes, base = list(counts[first:]), int(offs[first])
        trip = cd.triples_reference(plan_c, mid, qs, lanes, base, 0, COLS)
        for lay in cd.LAYOUTS:
            _equal(f"K2a {tag} layout {lay}",
                   cd.triples(plan_d, on(mid), on(qs), lanes, base, 0, COLS,
                              layout=lay), trip)
            paths.append(f"K2a layout {lay} C={k}")
        if ids is not None:
            seg = cd.segment_triples(plan_d, on(ids_t), lanes, base)
            want = cd.segment_triples_reference(plan_c, ids_t, lanes, base)
            _equal(f"K2s {tag}", seg, want)
            lo = base
            for j, cnt in enumerate(lanes):
                t = rt.replay_model(plan.cluster_init_counts,
                                    plan.cluster_init_total,
                                    ids[lo:lo + cnt]).astype(np.int64)
                require(np.array_equal(
                    want[:cnt, j].numpy(),
                    t[:, 0] | (t[:, 1] << 20) | (t[:, 2] << 40)),
                    f"K2s {tag}: lane {j}'s triples are the host replay's")
                lo += cnt
            paths.append(f"K2s C={k}")
        got = cd.encode_lanes_raw(plan_d, on(mid), on(qs), lanes, base,
                                  on(ids_t))
        want = cd.encode_lanes_raw(plan_c, mid, qs, lanes, base, ids_t)
        require(got[0] == want[0] and np.array_equal(got[1], want[1]),
                f"K2a + K2b {tag}: the lanes' payloads equal the plain "
                "version's")
        paths.append(f"K2b C={k}" + (" with the cluster-id segment"
                                     if ids is not None else ""))

        comp = host.encode(data, dist, n_clusters=k,
                           well_state=WellState.debug(), shards=SHARDS,
                           prime=prime, want_recon=False).compressed
        lc, ld = pdec.prepare_lanes(comp, "cpu"), pdec.prepare_lanes(comp,
                                                                     dev)
        _equal(f"K5p {tag}", [x for x in (ld.cl, ld.starts, ld.start_flags)
                              if x is not None],
               [x for x in (lc.cl, lc.starts, lc.start_flags)
                if x is not None])
        prologue_check(comp, ld, f"K5p {tag}")
        paths.append(f"K5p C={k}")
        rows = torch.zeros((lc.draws_t.shape[1], COLS + 1),
                           dtype=torch.uint8)
        fin = dd.decode_lanes_reference(lc.dplan_t, lc.pays, lc.draws_t,
                                        lc.cl, lc.lane_counts, 0, lc.starts,
                                        rows, 33)
        for lay in cd.LAYOUTS:
            o = torch.zeros(rows.shape, dtype=torch.uint8, device=dev)
            f = dd.decode_lanes_t(ld.dplan_t, ld.pays, ld.draws_t, ld.cl,
                                  ld.lane_counts, 0, ld.starts, o, 33,
                                  layout=lay)
            _equal(f"K5 + text rows {tag} layout {lay}", (f, o), (fin, rows))
            paths.append(f"K5 layout {lay} {tag}")
        if ids is not None:
            _prologue_flags(dev, comp, lc, tables, tag)
            paths.append(f"K5p C={k} on lanes it flags")

        out = port.encode(data, dist, n_clusters=k,
                          well_state=WellState.debug(), shards=SHARDS,
                          prime=prime, want_recon=False, device=dev)
        require(out.compressed == comp, f"{tag}: the encode on the card is "
                "byte-equal to the host engine")
        st: dict = {}
        dec = pdec.decode(comp, device=dev, stats=st)
        require(np.array_equal(dec, host.decode(comp))
                and st["fallback_lanes"] == 0,
                f"{tag}: decode(device='cuda') equals the host decoder")
        paths.append(f"encode + decode {tag}")

    ids = np.random.default_rng(3).integers(0, 40, N).astype(np.uint8)
    ids_t = torch.from_numpy(ids)
    shape = ts.card_hist_shape(data_t.to(dev), 40)
    require(shape["mode"] == 1, "K3 at C = 40 counts in device memory")
    _equal("K3 C=40 (mode 1)",
           ts.conditional_counts_t(data_t.to(dev), ids_t.to(dev), 40),
           ts.conditional_counts_reference(data_t, ids_t, 40))
    paths.append("K3 mode 1 C=40")


# model 0's (counts, total) of a lanes' bank on which the host's prologue
# fails: a total below the counts' sum (the tag leaves [l, u]) and above
# it (the search passes the last count)
FAILING_BANKS = (((40, 40, 40), 50), ((1, 1, 1), 1000))


def _prologue_flags(dev, comp, lanes, tables, tag: str) -> None:
    """K5p against its plain version and the host's prologue on the lanes
    of a -c 3 container under FAILING_BANKS: some lanes are flagged."""
    from qvz_tpu_torch.ops import coder_device as cd
    from qvz_tpu_torch.ops import decoder_device as dd

    cards = np.asarray(tables.model_card, dtype=np.int64)
    moff = np.asarray(tables.model_off, dtype=np.int64)
    pays_d = dd.LanePayloads(*(x.to(dev) for x in lanes.pays[:3]),
                             lanes.pays.lens)
    flagged = 0
    for counts, total in FAILING_BANKS:
        bank = np.concatenate([np.ones(int(moff[-1]), dtype=np.uint32),
                               cards.astype(np.uint32)])
        bank[:len(counts)], bank[int(moff[-1])] = counts, total
        dplan = dd.DecodePlan(cd.LanePlan(tables, bank), tables)
        got = dd.cluster_prologue(dd.decode_plan_to_torch(dplan, dev),
                                  pays_d, lanes.lane_counts)
        want = dd.cluster_prologue_reference(
            dd.decode_plan_to_torch(dplan, "cpu"), lanes.pays,
            lanes.lane_counts)
        _equal(f"K5p {tag} bank {counts} {total}", got, want)
        flagged += prologue_check(comp, lanes._replace(
            cl=got[0], starts=got[1], start_flags=got[2], bank=bank),
            f"K5p {tag} bank {counts} {total}")
    require(flagged > 0, f"K5p {tag}: the failing banks flag lanes")


def _rescale(torch, dev, paths: list) -> None:
    """K2a and K5 in layouts 0-2 with the records of models that rescale,
    K2b through the rescales and at long pending runs, K2s and K5p
    through model 0's rescale (chip_smoke.rescale_case at a small
    size)."""
    from chip_smoke import rescale_case
    from qvz_tpu_torch.constants import DISTORTION_MSE
    from qvz_tpu_torch.ops.distortion import make_matrix

    rescale_case(torch, np, make_matrix(DISTORTION_MSE), dev, lanes=8,
                 lines=600, rescales=1, tag="rescale:")
    paths.extend([f"K2a layout {lay} with records" for lay in (0, 1, 2)]
                 + ["K2b through rescales", "K2b pending runs of 31-100 bits",
                    "K2s through model 0's rescale",
                    "K5p through model 0's rescale"]
                 + [f"K5 layout {lay} with records" for lay in (0, 1, 2)])


def _kmeans(torch, dev, paths: list) -> None:
    """K4 in its three sums modes, each block walking three or more
    tiles (the planner's grid cut down to a third of the tiles)."""
    from qvz_tpu_torch.ops import kmeans as tk

    rng = np.random.default_rng(4)
    for k, n, cols, mode in ((3, N, COLS, 0), (150, N, COLS, 1),
                             (255, 700, 1022, 2)):
        data = (make_input(n, COLS, 5) if cols == COLS else
                rng.integers(0, 72, size=(n, cols)).astype(np.uint8))
        means = torch.from_numpy(data[rng.choice(n, k, replace=False)]
                                 .astype(np.int64))
        data_t = torch.from_numpy(np.ascontiguousarray(data.T))
        shape = tk.card_step_shape(data_t.to(dev), k)
        require(shape["mode"] == mode, f"K4 at K = {k} takes sums mode "
                f"{mode} (got {shape['mode']})")
        shape = dict(shape, grid=max(1, shape["tiles"] // 3))
        require(shape["tiles"] >= 3 * shape["grid"],
                f"K4 at K = {k}: three tiles a block or more")
        assign, sums = tk.launch(data_t.to(dev), tk.pack_means(
            means, shape["k_pad"]).to(dev), k, shape)
        a, s, c = tk.kmeans_step_reference(data_t, means)
        _equal(f"K4 K={k} mode {mode}", (assign.long(), sums),
               (a.long(), torch.cat([s, c[:, None]], 1)))
        paths.append(f"K4 mode {mode} K={k} {shape['tiles']} tiles on "
                     f"{shape['grid']} blocks")


def _well(torch, dev, paths: list) -> None:
    """KW on primed and unprimed plans: 100 columns (kQuad, 16-byte stores
    where the lane offsets allow), 37 and 3 (4-byte and single-byte
    stores, ragged lanes) and 1,000 (fewer streams a block); and at 14,600,
    60,000 and 60,001 columns (4-line and one-line tiles). KJ on those
    plans' streams, their states made from their offsets as the encode
    does, and on offsets of 0 and past 2^32 words."""
    from qvz_tpu_torch.ops import well_draws as wd
    from qvz_tpu_torch.ops import well_jump as wj
    from qvz_tpu_torch.ops.well import WellState
    from qvz_tpu_torch.pipeline import host

    warmup = host.PRIME_WARMUP_LINES
    host.PRIME_WARMUP_LINES = 512
    try:
        for n, cols, shards, prime in ((2051, 100, 16, True),
                                       (3001, 37, 8, True),
                                       (999, 3, 7, False),
                                       (700, 1000, 6, False)):
            counts, states, _, _ = host.shard_plan(n, cols, shards, prime,
                                                   WellState.debug())
            s_states, s_lines = wd.stream_plan(states, counts, cols)
            words = torch.from_numpy(s_states.view(np.int32))
            offsets = wd.stream_offsets(counts, cols)[0]
            _equal(f"KJ {n} x {cols}",
                   wj.states_t(host._state_words(WellState.debug()),
                               offsets, dev), words)
            paths.append(f"KJ {n} x {cols} {len(offsets)} streams")
            _equal(f"KW {n} x {cols}",
                   wd.draws_t(words.to(dev), s_lines, cols),
                   wd.draws_t_reference(words, s_lines, cols))
            paths.append(f"KW {n} x {cols} {len(s_lines)} streams")
    finally:
        host.PRIME_WARMUP_LINES = warmup
    v0 = host._state_words(WellState.debug())
    offsets = np.array([0, 1, 2**32 + 30_400, 2**40 + 3, 0], dtype=np.int64)
    _equal("KJ past 2^32 words", wj.states_t(v0, offsets, dev),
           wj.states_t(v0, offsets, "cpu"))
    paths.append(f"KJ {len(offsets)} streams past 2^32 words")
    # past 16 lines' shared memory: 4-line tiles, and one-line tiles in
    # chunks of columns (a multiple of 4 and not), against the host's draws
    for cols, lines in ((14600, [5, 9, 0, 13, 4, 7, 6]),
                        (60000, [2, 0, 3, 1] * 5), (60001, [2, 0, 3, 1] * 5)):
        states = np.random.default_rng(cols).integers(
            0, 2**32, size=(len(lines), 32), dtype=np.uint64) \
            .astype(np.uint32)
        _equal(f"KW {sum(lines)} x {cols}",
               wd.draws_t(torch.from_numpy(states.view(np.int32)).to(dev),
                          lines, cols),
               torch.from_numpy(np.ascontiguousarray(
                   host._shard_draws(states, lines, cols).T)))
        paths.append(f"KW {sum(lines)} x {cols} {len(lines)} streams")


def _microbench(torch, dev, paths: list) -> None:
    from qvz_tpu_torch import microbench as mb

    x = mb.issue_input()
    for op in mb.ISSUE_OPS:
        _equal(f"issue {op}", mb.issue(x.to(dev), 40, op, tiles=2),
               mb.issue_reference(x, 40, op, 2))
        paths.append(f"issue {op}")
    for shape in ((64, 8, 128), (64, 512)):
        _, _, kw, c = mb.mix_input(shape)
        _equal(f"mix {shape}", mb.mix(12, kw.to(dev), c.to(dev)),
               mb.mix_reference(12, kw, c))
        paths.append(f"mix {len(shape)}-D")
    _, _, kw, c = mb.mix_input((64, 8, 128))
    for mode in ("sel", "sel_b4", "sweeponly"):
        _equal(f"selmix {mode}", mb.selmix(12, kw.to(dev), c.to(dev), mode),
               mb.selmix_reference(12, kw, c, mode))
        paths.append(f"selmix {mode}")


def child(tool: str) -> int:
    import torch

    from qvz_tpu_torch import _build

    t0 = time.perf_counter()
    require(torch.cuda.is_available(), "a CUDA card is visible")
    dev = torch.device("cuda")
    _build.load(lineinfo=True)
    _build.LAUNCHES.clear()
    paths: list = []
    _stats_quantize_code(torch, dev, paths)
    _rescale(torch, dev, paths)
    _kmeans(torch, dev, paths)
    _well(torch, dev, paths)
    _microbench(torch, dev, paths)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for k in KERNELS:
        require(launches.get(k, 0) > 0, f"{k} launched")
    res = {"tool": tool, "kernels": list(KERNELS), "paths": paths,
           "launches": launches}
    if tool in ("memcheck", "none"):
        t1 = time.perf_counter()
        res["corpus"] = check_corpus(corpus())
        torch.cuda.synchronize()
        res["corpus"]["seconds"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


# -- the four tools ----------------------------------------------------------

def sanitizer() -> str:
    """compute-sanitizer's path: beside nvcc, under CUDA_HOME, or on PATH."""
    from qvz_tpu_torch import _build
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(pathlib.Path(os.environ[env]) / "bin")
    try:
        cands.append(pathlib.Path(_build.nvcc()).parent)
    except RuntimeError:
        pass
    for d in cands:
        if (d / "compute-sanitizer").exists():
            return str(d / "compute-sanitizer")
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    raise RuntimeError("compute-sanitizer not found: not beside nvcc, under "
                       "CUDA_HOME or on PATH")


def _summary(text: str) -> int:
    """The error count of a compute-sanitizer summary line."""
    m = re.findall(r"(?:ERROR|RACECHECK|SYNCCHECK|INITCHECK) SUMMARY: "
                   r"(\d+) (?:error|hazard)", text)
    return int(m[-1]) if m else -1


def _probe(cs: str) -> None:
    """One CUDA allocation under memcheck; raises with the tool's message
    where it cannot check this card."""
    r = subprocess.run([cs, "--tool", "memcheck", "--error-exitcode", "99",
                        sys.executable, "-c",
                        "import torch; torch.zeros(8, device='cuda'); "
                        "torch.cuda.synchronize()"],
                       capture_output=True, text=True, timeout=300)
    text = r.stdout + r.stderr
    errs = [ln.strip("= ").strip() for ln in text.splitlines()
            if "Error:" in ln]
    if r.returncode != 0 or errs:
        raise RuntimeError(
            f"compute-sanitizer ({cs}) cannot check this card: "
            + ("; ".join(errs) or f"exit {r.returncode}: {text[-2000:]}"))


def main() -> int:
    import torch

    from qvz_tpu_torch import _build

    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 1
    cs = sanitizer()
    _probe(cs)
    t = time.perf_counter()
    path = _build.lib_path(lineinfo=True)
    if not path.exists():
        _build.build(path, lineinfo=True)
    print(f"line-info build {path.name} in {time.perf_counter() - t:.1f} s",
          flush=True)
    env = {**os.environ, "PYTORCH_NO_CUDA_MEMORY_CACHING": "1"}
    failed = []
    for tool in TOOLS:
        t = time.perf_counter()
        r = subprocess.run(
            [cs, "--tool", tool, "--error-exitcode", "99", "--kernel-name",
             f"regex={KERNEL_REGEX}", sys.executable, str(pathlib.Path(
                 __file__).resolve()), "--child", tool],
            capture_output=True, text=True, env=env, timeout=3000)
        secs = time.perf_counter() - t
        text = r.stdout + r.stderr
        errors = _summary(text)
        rec = next((json.loads(ln) for ln in reversed(r.stdout.splitlines())
                    if ln.startswith("{")), None)
        print(f"{tool}: exit {r.returncode}, {errors} errors, {secs:.1f} s; "
              + (f"kernels {rec['kernels']}, launches {rec['launches']}, "
                 f"{len(rec['paths'])} code paths"
                 + (f", corpus {rec['corpus']}" if "corpus" in rec else "")
                 if rec else "no record from the child"), flush=True)
        if r.returncode != 0 or errors != 0 or rec is None:
            failed.append(tool)
            print(text[-6000:], flush=True)
    if failed:
        print(f"failed: {failed}", flush=True)
        return 1
    print("compute-sanitizer: memcheck, racecheck, synccheck and initcheck "
          "report 0 errors", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        sys.exit(child(sys.argv[2]))
    if len(sys.argv) != 1:
        sys.exit(f"usage: {sys.argv[0]} [--child TOOL]")
    sys.exit(main())
