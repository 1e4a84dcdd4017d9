"""Lane-parallel adaptive arithmetic encoder on the device.

The QVZ2 container's shards are independent adaptive arithmetic streams
(column-major symbol order, a shared primed model bank). Each shard after
the warmup shard is one lane; lanes are coded in parallel and produce
payload bytes identical to the host coder (qvz_rt.cpp Encoder/ModelBank;
reference src/arith.c:24-96, src/qv_stream.c:9-61). Counterpart of
``qvz_tpu.ops.coder_device``; K2 (``csrc/coder.cu``) replaces
``qvz_tpu.ops.coder_pallas._kernel3`` with two CUDA kernels that run in
turn over chunks of columns (``chunk_columns``):

  K2a  the triples: for every (column, lane) in parallel, each step's
       model triple (cum_lo, cum_hi, total) from the lane's earlier lines
       in that column, packed in an int64 of three 20-bit fields into a
       step-major (step, lane) buffer; plain version ``triples_reference``
  K2b  the chain: the serial interval arithmetic of each lane over its
       triples, its state carried from chunk to chunk; plain version
       ``chain_reference``

``encode_lanes_reference`` is their composition. The encoder knows every
symbol before it codes, so a triple never depends on the interval.

Every model updates after each step as the host's ModelBank::update
(reference src/qv_stream.c:9-25): the step codes with the current counts,
then c[x] += 8, and where the total passes 2^19 every count becomes
(c >> 1) + 1. K2a marks the models that can rescale inside a lane ("at
risk", ``risk_tables``) and gives each lane a record of their counts in
device memory (csrc/rescale.cuh); a chunk with none runs without records.
So every lane codes every step on the device, and no lane is sent to the
host.

That module imports JAX when it loads, so the numpy parts the port needs
are copied here: the per-column slot layout of ``LanePlan`` and
``finish_payload``.

With more than one cluster (-c K > 1), each lane first codes its lines'
cluster ids, one step per line before column 0: the cluster-id segment.
K2s (``segment_triples``, ``csrc/coder.cu``) makes its triples on the
device from the lanes' ids, one thread a lane replaying the cluster-id
model exactly as the host's ``rt.replay_model`` (rescale included); K2b
codes them as one column. Plain version ``segment_triples_reference``.

Raw lane output, shared by K2 and its plain version:
  words   (W, max_words) int32  the lane's packed 32-bit words (u32 bits)
  n_words (W,) int32            how many of them are valid
  carry   (6, W) int64          l, u, scale3, pending bits, pending bit
                                count, overrun
Overrun is K2b's mark of a lane whose words would pass max_words, which
``code_lanes``'s sizing rules out: ``payloads_from_raw`` raises on it.
No lane is flagged otherwise; a pending run of any length is emitted.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from qvz_tpu_torch.constants import ADAPTIVE_STEP, ARITH_M, ARITH_R
from qvz_tpu_torch import _build

FULL = (1 << ARITH_M) - 1
MSB_SHIFT = ARITH_M - 1          # 21
SMSB_SHIFT = ARITH_M - 2         # 20
MSB_BIT = 1 << MSB_SHIFT
MSB_CLEAR = MSB_BIT - 1
STEP = ADAPTIVE_STEP
U32 = 0xFFFFFFFF
# K2's output bound: a lane emits at most 21 bits per coding step (see
# csrc/coder.cu); words are sized for 22.
BITS_PER_STEP_BOUND = 22
_TOTAL_BITS = 20         # a model record packs card << 20 | initial total
_TOTAL_MASK = (1 << _TOTAL_BITS) - 1
# A triple packs cum_lo, cum_hi and total in three 20-bit fields of an
# int64; 0 is a step that codes nothing.
FIELD_BITS = 20
FIELD_MASK = (1 << FIELD_BITS) - 1
# Device memory for one chunk of K2a's triples, 8 bytes a (column, line of
# the longest lane, lane): columns run in chunks of as many as fit.
TRIPLE_BYTES = 1 << 30
# K2a's launch shape: lanes walked in each warp, at most 32 lanes a block,
# steps a tile; and K2b's lanes in each warp (a block is one warp). The
# lanes a warp are the fastest of chip_smoke.py's sweep (PERF.md).
LANES_PER_WARP = 4
CHAIN_LANES_PER_WARP = 8
_LANES_PER_BLOCK = 32
TILE_STEPS = 64
# K2a's and K5's layouts, in the order a plan tries them (csrc/coder.cu,
# csrc/decoder.cu): 0 the column's tables and the lanes' uses in shared
# memory, 1 the tables in device memory, 2 the uses there too.
LAYOUTS = (0, 1, 2)
_K2A_STATIC_SMEM = 32 * 12   # K2a's static shared memory: lane offsets
_SMEM_RESERVED = 1024    # shared memory the card keeps for each block


class LanePlan:
    """Per-(tables, init bank) slot layout of the lane coder (copied from
    ``qvz_tpu.ops.coder_device.LanePlan``, the fields the kernel reads).

    Column c's models (ids 1 + 2*(pair_base(cl, c) + ctx) + choice,
    col_models[c]) get consecutive slot ranges; slot = slot_base[model]
    + symbol indexes
    that model's count inside the column. S is the largest slot count
    of any column. totals are the init bank's model totals; the
    cluster-id model (id 0) starts from cluster_init_counts and
    cluster_init_total."""

    def __init__(self, tables, init_bank: np.ndarray | None):
        cards = np.asarray(tables.model_card, dtype=np.int64)
        offs = np.asarray(tables.model_off, dtype=np.int64)
        n_models = int(tables.n_models)
        cols = int(tables.columns)
        n_cl = int(tables.n_clusters)
        pb = np.asarray(tables.pair_base,
                        dtype=np.int64).reshape(n_cl, cols)
        pb_flat = pb.reshape(-1)
        nxt = np.append(pb_flat[1:], int(tables.n_pairs))
        nctx = (nxt - pb_flat).reshape(n_cl, cols)

        if init_bank is None:
            counts_init = np.ones(int(offs[-1]), dtype=np.uint32)
            totals_init = cards.astype(np.uint32)
        else:
            blob = np.asarray(init_bank, dtype=np.uint32)
            counts_init = blob[: int(offs[-1])]
            totals_init = blob[int(offs[-1]): int(offs[-1]) + n_models]

        slot_base = np.zeros(n_models, dtype=np.int32)
        col_models = []
        col_slots = np.zeros(cols, dtype=np.int64)
        for c in range(cols):
            ms = []
            for cl in range(n_cl):
                base = 1 + 2 * int(pb[cl, c])
                ms.extend(range(base, base + 2 * int(nctx[cl, c])))
            ms = np.asarray(ms, dtype=np.int64)
            col_models.append(ms)
            sb = np.concatenate([[0], np.cumsum(cards[ms])[:-1]])
            slot_base[ms] = sb
            col_slots[c] = int(cards[ms].sum())
        S = int(col_slots.max()) if cols else 1

        init_counts_cols = np.ones((cols, S), dtype=np.uint32)
        init_prefix_cols = np.zeros((cols, S), dtype=np.uint32)
        for c in range(cols):
            ms = col_models[c]
            parts = [counts_init[offs[m]: offs[m] + cards[m]] for m in ms]
            v = np.concatenate(parts) if parts else \
                np.zeros(0, dtype=np.uint32)
            init_counts_cols[c, : len(v)] = v
            # each slot's initial counts below it inside its model
            below = np.cumsum(v, dtype=np.int64) - v
            first = np.repeat(slot_base[ms].astype(np.int64), cards[ms])
            init_prefix_cols[c, : len(v)] = below - below[first]

        # per-column model records, each column's models from
        # col_model_off[c], mloc a model's index among them: slot base and
        # card << 20 | initial total. A bank's totals are at most 2^19 (the
        # coder rescales past it), so they fit the 20-bit field and the
        # triples' fields.
        if totals_init.size and int(totals_init.max()) > ARITH_R:
            raise ValueError(f"a model total of {int(totals_init.max())} "
                             f"passes {ARITH_R}: not a bank the coder makes")
        mloc = np.zeros(n_models, dtype=np.int32)
        recs = []
        tot = totals_init.astype(np.int64)
        for ms in col_models:
            mloc[ms] = np.arange(len(ms))
            recs.append(np.stack([slot_base[ms].astype(np.int64),
                                  (cards[ms] << _TOTAL_BITS) | tot[ms]], 1))
        self.mloc = mloc
        self.mtab = (np.concatenate(recs) if recs
                     else np.zeros((0, 2), np.int64)).astype(np.int32)
        self.col_model_off = np.concatenate(
            [[0], np.cumsum([len(ms) for ms in col_models])]
        ).astype(np.int32)

        self.S = S
        self.init_prefix_cols = init_prefix_cols
        self.columns = cols
        self.n_clusters = n_cl
        self.col_models = col_models
        self.init_counts_cols = init_counts_cols
        self.slot_base = slot_base
        self.cards = cards.astype(np.int32)
        self.col_slots = col_slots.astype(np.int32)
        self.totals = totals_init.astype(np.uint32)
        self.cluster_init_counts = counts_init[: int(cards[0])].copy()
        self.cluster_init_total = int(totals_init[0])


def plan_to_torch(plan: LanePlan, device) -> dict:
    """The plan's tables as int32 tensors on `device`."""
    def t(a):
        return torch.from_numpy(
            np.array(a, dtype=np.int32, copy=True)).to(device)

    return {
        "S": int(plan.S),
        "columns": int(plan.columns),
        "models_max": int(np.diff(plan.col_model_off).max(initial=0)),
        # the model records on the host, for risk_tables
        "mtab_h": plan.mtab,
        "col_model_off_h": plan.col_model_off,
        "slot_base": t(plan.slot_base),
        "cards": t(plan.cards),
        "init_counts": t(plan.init_counts_cols),
        "init_prefix": t(plan.init_prefix_cols),
        "col_slots": t(plan.col_slots),
        "mloc": t(plan.mloc),
        "mtab": t(plan.mtab),
        "col_model_off": t(plan.col_model_off),
        # the cluster-id model's (model 0's) counts and total at a lane's
        # start, for K2s and K5p
        "cluster_init": t(plan.cluster_init_counts),
        "cluster_total": int(plan.cluster_init_total),
    }


def _lane_offsets(lane_counts, base: int, device) -> torch.Tensor:
    offs = base + np.concatenate([[0], np.cumsum(lane_counts)])
    return torch.as_tensor(offs.astype(np.int64), device=device)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values below 2^53 (0 -> 0)."""
    return torch.frexp(x.double())[1].long()


def _put(acc, nacc, val, p):
    """Append p (in [0, 32]) bits of val to the MSB-first pending bits
    (acc, nacc), nacc < 32; returns (acc', nacc', word, flushed)."""
    acc = (acc << p) | val
    nacc = nacc + p
    flushed = nacc >= 32
    nacc = torch.where(flushed, nacc - 32, nacc)
    word = (acc >> nacc) & U32
    acc = torch.where(flushed, acc & ((1 << nacc) - 1), acc)
    return acc, nacc, word, flushed


def _coder_step(l, u, s3, acc, nacc, clo, chi, n):
    """One arithmetic-coder step across all lanes, in int64: the maths of
    ``qvz_tpu.ops.coder_device._coder_step`` (the host Encoder::step with
    batched E1*/E3* renormalisation), with a pending run of any length
    emitted as the host's bit writer emits it. Returns the new state and
    the (word, flushed) pairs of the step's bit packing."""
    rng = u - l + 1
    u = l + rng * chi // n - 1
    l = l + rng * clo // n

    # E1* batch: k1 shared leading bits; the first, then scale3
    # complements, then the other k1 - 1.
    diff = l ^ u
    e1 = (diff >> MSB_SHIFT) == 0
    k1 = torch.where(e1, ARITH_M - _bit_length(diff), 0)
    k1m1 = (k1 - 1).clamp(min=0)
    top = l >> (ARITH_M - k1)
    first = top >> k1m1
    low = top & ((1 << k1m1) - 1)
    nbits = torch.where(e1, k1 + s3, 0)
    if bool((nbits > 63).any()):
        # a pending run past 62 bits, rare: the first bit, the run in
        # pieces of 32, the low bits
        runs = torch.where(e1, s3, 0)
        puts = [(first, e1.long())]
        for k in range(-(-int(runs.max()) // 32)):
            p = (runs - 32 * k).clamp(0, 32)
            puts.append((torch.where(first == 0, (1 << p) - 1, 0), p))
        puts.append((low, torch.where(e1, k1m1, 0)))
    else:
        comp = torch.where(first == 0,
                           ((1 << s3.clamp(max=62)) - 1) << k1m1, 0)
        v = torch.where(e1, (first << (nbits - 1).clamp(min=0)) | comp | low,
                        0)
        # bits >= 32 of the emission first, then the low 32
        puts = [(v >> 32, (nbits - 32).clamp(min=0)),
                (v & U32, nbits.clamp(max=32))]
    s3 = torch.where(e1, 0, s3)
    l = (l << k1) & FULL
    u = ((u << k1) | ((1 << k1) - 1)) & FULL

    # E3* batch: scale3 += k3, no emission.
    e3 = ((l >> SMSB_SHIFT) == 1) & ((u >> SMSB_SHIFT) == 2)
    lx = (l << (32 - SMSB_SHIFT)) & U32
    ux = (u << (32 - SMSB_SHIFT)) & U32
    lrun = 32 - _bit_length((~lx | 1) & U32)
    zrun = 32 - _bit_length(ux)
    k3 = torch.where(e3, 1 + torch.minimum(lrun, zrun), 0)
    s3 = s3 + k3
    l = torch.where(e3, (l << k3) & MSB_CLEAR, l)
    u = torch.where(e3, ((u << k3) & MSB_CLEAR) | MSB_BIT | ((1 << k3) - 1),
                    u)

    out = []
    for val, p in puts:
        acc, nacc, w, f = _put(acc, nacc, val, p)
        out.append((w, f))
    return (l, u, s3, acc, nacc), out


def pack_triples(cum_lo, cum_hi, total):
    """The int64 triple of three 20-bit fields that K2a writes."""
    return cum_lo | (cum_hi << FIELD_BITS) | (total << (2 * FIELD_BITS))


# K2s's lanes a block (one thread a lane; model 0's counts, at most 256
# u32 a lane, in shared memory)
SEGMENT_LANES_PER_BLOCK = 32


def segment_triples_reference(plan_t: dict, clusters: torch.Tensor,
                              lane_counts, base: int) -> torch.Tensor:
    """Plain PyTorch version of K2s: the cluster-id segment of lane w, the
    ids clusters[base + sum(lane_counts[:w]) ...] for lane_counts[w]
    lines, as the packed triples of the cluster-id model (model 0) from
    the plan's cluster_init counts and cluster_total, each step updating
    them as the host's ModelBank::update (+8, and past 2^19 every nonzero
    count (c >> 1) + 1): ``rt.replay_model``'s triples. Vectorised over
    lanes in int64; returns K2b's step-major (L, W) int64 triples, 0 past
    a ragged lane's end (L the longest lane)."""
    dev = clusters.device
    W = len(lane_counts)
    L = int(max(lane_counts)) if W else 0
    offs = _lane_offsets(lane_counts, base, dev)
    c = plan_t["cluster_init"].to(dev).long().expand(W, -1).clone()
    card = c.shape[1]
    total = torch.full((W,), plan_t["cluster_total"], dtype=torch.long,
                       device=dev)
    lens = offs[1:] - offs[:-1]
    ar = torch.arange(card, device=dev)
    ar_w = torch.arange(W, device=dev)
    out = torch.zeros((L, W), dtype=torch.long, device=dev)
    for j in range(L):
        v = j < lens
        x = torch.where(v, clusters[(offs[:-1] + j).clamp(
            max=clusters.numel() - 1)].long(), 0)
        cum = (c * (ar < x[:, None])).sum(1)
        cx = c[ar_w, x]
        out[j] = torch.where(v, pack_triples(cum, cum + cx, total), 0)
        c[ar_w, x] += STEP * v
        n = total + STEP * v
        resc = v & (n > ARITH_R)
        if bool(resc.any()):
            h = torch.where(c != 0, (c >> 1) + 1, 0)
            c = torch.where(resc[:, None], h, c)
            n = torch.where(resc, h.sum(1), n)
        total = n
    return out


def segment_triples(plan_t: dict, clusters: torch.Tensor, lane_counts,
                    base: int) -> torch.Tensor:
    """K2s: the cluster-id segment's triples as ``segment_triples_reference``
    returns them, from the (N,) uint8 cluster ids (each below the plan's
    cluster count) on their device. CPU tensors take the plain version;
    CUDA tensors launch K2s (csrc/coder.cu), one thread a lane, or
    raise."""
    _check_clusters(plan_t, clusters, lane_counts, base)
    dev = clusters.device
    if dev.type == "cpu":
        return segment_triples_reference(plan_t, clusters, lane_counts, base)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load()
    W = len(lane_counts)
    L = int(max(lane_counts)) if W else 0
    offs = _lane_offsets(lane_counts, base, dev)
    trip = torch.empty((L, W), dtype=torch.int64, device=dev)
    init = plan_t["cluster_init"]
    _build.launch("coder_segment", "cluster-id segment kernel", dev,
                  lib.qvz_coder_segment, clusters.contiguous().data_ptr(),
                  offs.data_ptr(), W, L, init.data_ptr(), init.numel(),
                  plan_t["cluster_total"], trip.data_ptr(),
                  SEGMENT_LANES_PER_BLOCK)
    return trip


def _check_clusters(plan_t, clusters, lane_counts, base) -> None:
    if clusters.dtype != torch.uint8 or clusters.dim() != 1:
        raise ValueError("clusters must be (N,) uint8 cluster ids")
    if base < 0 or base + int(np.sum(lane_counts)) > clusters.numel():
        raise ValueError("clusters: lanes run past the cluster ids")
    if plan_t["cluster_init"].numel() < 2:
        raise ValueError("the plan has one cluster: clusters have no "
                         "segment to code")
    if plan_t["cluster_init"].device != clusters.device:
        raise ValueError("clusters and plan must share one device")


def chunk_columns(cols: int, lanes: int, lmax: int, rec_max: int = 0) -> int:
    """Columns a chunk of K2a's triples holds within TRIPLE_BYTES, with
    its lanes' records (rec_max entries of 8 bytes a lane and column, the
    most of ``risk_tables``), and K2a's grid: at most 65,535."""
    return max(1, min(cols, 65535, TRIPLE_BYTES
                      // max(1, 8 * lanes * (lmax + rec_max))))


def start_raw(W: int, device, max_words: int = 0):
    """The raw lane output of lanes that have coded nothing yet, with room
    for max_words words a lane (K2b writes into it)."""
    carry = torch.zeros((6, W), dtype=torch.long, device=device)
    carry[1] = FULL
    return (torch.zeros((W, max_words), dtype=torch.int32, device=device),
            torch.zeros(W, dtype=torch.int32, device=device), carry)


def risk_tables(plan_t: dict, lmax: int) -> dict:
    """The models at risk of a plan for lanes of at most lmax lines: those
    (with more than one symbol) whose initial total + 8 x lmax passes
    2^19, the only ones that can rescale inside a lane (csrc/rescale.cuh).
    Each has a record of card + 1 entries (its total, then each slot's
    prefix and count) in a lane's records of its column:
      rbase  (models,) int32, aligned with mtab: the model's record
             offset in its column's records, -1 where not at risk
      rsrc   int32, each column's record sources from roff[c]: -1 - the
             column-local model for a record's head, else the slot
      roff   (cols + 1,) int32 and roff_h, the same on the host
      models the number of models at risk; rec_max the most entries of a
             column.
    Cached in plan_t for each lmax."""
    cache = plan_t.setdefault("risk", {})
    if lmax in cache:
        return cache[lmax]
    mt = np.asarray(plan_t["mtab_h"], dtype=np.int64).reshape(-1, 2)
    cmo = np.asarray(plan_t["col_model_off_h"], dtype=np.int64)
    card = mt[:, 1] >> _TOTAL_BITS
    risk = (card > 1) & ((mt[:, 1] & _TOTAL_MASK) + STEP * lmax > ARITH_R)
    size = np.where(risk, card + 1, 0)
    col = np.repeat(np.arange(len(cmo) - 1), np.diff(cmo))
    before = np.cumsum(size) - size             # entries before each model
    roff = np.append(before[cmo[:-1]] if len(mt) else
                     np.zeros(len(cmo) - 1, np.int64), size.sum())
    g = np.flatnonzero(risk)
    ne = size[g]
    pos = np.arange(int(ne.sum())) - np.repeat(np.cumsum(ne) - ne, ne)
    gi = np.repeat(g, ne)
    rsrc = np.where(pos == 0, -1 - (gi - cmo[col[gi]]), mt[gi, 0] + pos - 1)
    dev = plan_t["mtab"].device

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    cache[lmax] = out = {
        "rbase": t(np.where(risk, before - roff[col], -1)),
        "rsrc": t(rsrc), "roff": t(roff), "roff_h": roff,
        "models": int(risk.sum()),
        "rec_max": int(np.diff(roff).max(initial=0))}
    return out


def triples_reference(plan_t: dict, mid: torch.Tensor, qs: torch.Tensor,
                      lane_counts, base: int, c0: int, c1: int):
    """Plain PyTorch version of K2a over columns c0 .. c1 - 1: every
    (column, lane) in parallel, the steps in a loop, each with its counts
    and model totals as the host coder keeps them (ModelBank::update: +8,
    and the exact rescale past 2^19). Returns the triples, (ncols * L, W)
    int64 with row cc * L + j for line j of column c0 + cc (L the longest
    lane; 0 where a step codes nothing)."""
    dev = mid.device
    W = len(lane_counts)
    L = int(max(lane_counts)) if W else 0
    S = plan_t["S"]
    nc = c1 - c0
    R = nc * W                                 # (column, lane) rows
    A = 72  # no model has more symbols than the alphabet

    offs = _lane_offsets(lane_counts, base, dev)
    j = torch.arange(L, device=dev)
    valid = j[None, :] < (offs[1:] - offs[:-1])[:, None]          # (W, L)
    idx = torch.where(valid, offs[:-1, None] + j[None, :], 0)
    m = torch.where(valid, mid[c0:c1][:, idx].long(), 0).reshape(R, L)
    x = torch.where(valid, qs[c0:c1][:, idx].long(), 0).reshape(R, L)
    cmo = plan_t["col_model_off"].long()
    mloc = plan_t["mloc"].long()[m]
    mtab = plan_t["mtab"].long()
    rec = mtab[(cmo[c0:c1].repeat_interleave(W)[:, None] + mloc)
               .clamp(max=max(len(mtab) - 1, 0))]                 # (R, L, 2)
    sb = rec[..., 0]
    card = rec[..., 1] >> _TOTAL_BITS
    live = (m > 0) & (card > 1)

    # each row's counts and model totals, from its column's initial ones
    cnt = plan_t["init_counts"][c0:c1].repeat_interleave(W, 0)    # (R, S)
    mm = max(plan_t["models_max"], 1)
    ml_ar = torch.arange(mm, device=dev)
    g0 = (cmo[c0:c1, None] + ml_ar).clamp(max=max(len(mtab) - 1, 0))
    tot = torch.where(ml_ar < (cmo[c0 + 1:c1 + 1] - cmo[c0:c1])[:, None],
                      mtab[g0, 1] & _TOTAL_MASK, 0)
    tot = tot.int().repeat_interleave(W, 0)                        # (R, mm)
    ar = torch.arange(A, device=dev)
    ar_r = torch.arange(R, device=dev)
    out = torch.zeros((L, R), dtype=torch.long, device=dev)
    for t in range(L):
        mlt, sbt, xt, lv = mloc[:, t], sb[:, t], x[:, t], live[:, t]
        slots = (sbt[:, None] + ar).clamp(max=S - 1)
        g = cnt.gather(1, slots)
        cum_lo = (g * (ar < xt[:, None])).sum(1)
        cum_hi = cum_lo + g.gather(1, xt[:, None].clamp(max=A - 1))[:, 0]
        total = tot[ar_r, mlt].long()
        out[t] = torch.where(lv, pack_triples(cum_lo, cum_hi, total), 0)
        cnt[ar_r, (sbt + xt).clamp(max=S - 1)] += STEP * lv.int()
        n = total + STEP * lv
        resc = lv & (n > ARITH_R)
        if bool(resc.any()):
            # every count of the model becomes (c >> 1) + 1, the total
            # their sum
            rr = resc.nonzero()[:, 0]
            inm = ar < card[rr, t][:, None]
            h = torch.where(inm, (cnt[rr[:, None], slots[rr]] >> 1) + 1, 0)
            cnt[rr[:, None].expand_as(h)[inm], slots[rr][inm]] = h[inm]
            n[rr] = h.sum(1)
        tot[ar_r, mlt] = n.int()
    return out.reshape(L, nc, W).permute(1, 0, 2).reshape(nc * L, W)


def chain_reference(trip: torch.Tensor, ncols: int, lane_counts,
                    raw=None):
    """Plain PyTorch version of K2b: the lanes' interval arithmetic over
    ncols columns of (ncols * L, W) triples (as ``triples_reference``
    gives them; 0 codes nothing), vectorised over lanes, in int64, from
    the raw lane output `raw` (``start_raw`` if None). Returns the raw
    lane output with the chunk's words appended."""
    dev = trip.device
    W = len(lane_counts)
    L = trip.shape[0] // max(ncols, 1)
    words_in, n_in, carry = start_raw(W, dev) if raw is None else raw
    l, u, s3, acc, nacc = (carry[k].clone() for k in range(5))
    lens = torch.as_tensor(np.asarray(lane_counts, dtype=np.int64),
                           device=dev)
    words, flushes = [], []
    for cc in range(ncols):
        for j in range(L):
            t = trip[cc * L + j]
            lv = (j < lens) & ((t >> (2 * FIELD_BITS)) != 0)
            # a step that codes nothing takes the no-op triple (0, 1, 1)
            (l, u, s3, acc, nacc), puts = _coder_step(
                l, u, s3, acc, nacc,
                torch.where(lv, t & FIELD_MASK, 0),
                torch.where(lv, (t >> FIELD_BITS) & FIELD_MASK, 1),
                torch.where(lv, t >> (2 * FIELD_BITS), 1))
            for w, f in puts:
                words.append(w)
                flushes.append(f)

    carry = torch.stack([l, u, s3, acc, nacc, carry[5]])
    if not words:
        return words_in, n_in, carry
    wt = torch.stack(words, 1)                                    # (W, 2T)
    ft = torch.stack(flushes, 1)
    n_words = n_in.long() + ft.sum(1)
    width = int(n_words.max()) if W else 0
    out = torch.zeros((W, width), dtype=torch.long, device=dev)
    keep = min(width, words_in.shape[1])
    out[:, :keep] = words_in[:, :keep].long() & U32
    dst = n_in.long()[:, None] + ft.long().cumsum(1) - 1
    lane = torch.arange(W, device=dev)[:, None].expand_as(dst)
    out[lane[ft], dst[ft]] = wt[ft]
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(torch.int32), n_words.to(torch.int32), carry


def encode_lanes_reference(plan_t: dict, mid: torch.Tensor,
                           qs: torch.Tensor, lane_counts, base: int,
                           clusters: torch.Tensor | None = None):
    """Plain PyTorch version of K2: the cluster-id segment first when
    clusters is given (``segment_triples_reference``, then its chain),
    then ``triples_reference`` and ``chain_reference`` over chunks of
    ``chunk_columns`` columns, as ``code_lanes`` launches K2s, K2a and
    K2b. Returns the raw lane output (words, n_words, carry) described in
    the module docstring."""
    return _compose(segment_triples_reference, triples_reference,
                    chain_reference, plan_t, mid, qs, lane_counts, base,
                    clusters, start_raw(len(lane_counts), mid.device))


def _compose(segment_fn, triples_fn, chain_fn, plan_t, mid, qs, lane_counts,
             base, clusters, raw):
    """K2 from its parts: the segment's triples and chain, then each
    chunk's triples and chain."""
    cols = mid.shape[0]
    W = len(lane_counts)
    L = int(max(lane_counts)) if W else 0
    if clusters is not None:
        raw = chain_fn(segment_fn(plan_t, clusters, lane_counts, base), 1,
                       lane_counts, raw)
    k = chunk_columns(cols, W, L, risk_tables(plan_t, L)["rec_max"])
    for c0 in range(0, cols, k):
        c1 = min(cols, c0 + k)
        trip = triples_fn(plan_t, mid, qs, lane_counts, base, c0, c1)
        raw = chain_fn(trip, c1 - c0, lane_counts, raw)
    return raw


def _check(plan_t, mid, qs, lane_counts, base, clusters):
    if clusters is not None:
        _check_clusters(plan_t, clusters, lane_counts, base)
        if clusters.numel() != mid.shape[-1]:
            raise ValueError(f"clusters must be ({mid.shape[-1]},), one id "
                             "a line of the quantize outputs")
    if mid.dtype != torch.int32 or qs.dtype != torch.int32:
        raise TypeError("mid and qs must be int32")
    if mid.dim() != 2 or qs.shape != mid.shape:
        raise ValueError("mid and qs must be one (cols, N) shape")
    if mid.shape[0] != plan_t["columns"]:
        raise ValueError(f"{mid.shape[0]} columns, plan has "
                         f"{plan_t['columns']}")
    if base < 0 or base + int(np.sum(lane_counts)) > mid.shape[1]:
        raise ValueError("lanes run past the quantize outputs")
    if qs.device != mid.device \
            or plan_t["init_counts"].device != mid.device:
        raise ValueError("inputs and plan must share one device")


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def triples_shape(S: int, models_max: int, lmax: int, smem_block: int,
                  smem_sm: int, lanes_per_warp: int = LANES_PER_WARP,
                  layout: int | None = None) -> dict:
    """K2a's block shape for a plan of S slots and at most models_max
    models a column, lanes of at most lmax lines: lanes_per_warp lanes in
    each warp, tiles of up to TILE_STEPS steps, and the lanes a block (at
    most 32) that put the most lanes on an SM within smem_block bytes of
    shared memory a block, smem_sm an SM and 2,048 threads an SM. The
    layout (csrc/coder.cu, triples_kernel) is the first of LAYOUTS in
    which one lane fits, or `layout` where given (which raises if even one
    lane does not fit it): 0 stages the column's tables and keeps each
    lane's uses (a u16 a slot and a model) in shared memory, 1 reads the
    tables from device memory, 2 keeps the uses there too; every layout
    keeps a u32 a tile step in shared memory."""
    if lanes_per_warp not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes_per_warp {lanes_per_warp} is not a power "
                         "of two up to 32")
    s_pad, m_pad = _round8(max(S, 1)), _round8(max(models_max, 1))
    lt = min(_round8(max(lmax, 1)), TILE_STEPS)
    tables = (m_pad * 8 + s_pad * 8, 0, 0)
    uses = ((s_pad + m_pad) * 2,) * 2 + (0,)

    for lay in LAYOUTS if layout is None else (layout,):
        def size(lpb):
            return tables[lay] + lpb * (uses[lay] + lt * 4)

        best = None
        for lpb in range(_LANES_PER_BLOCK, 0, -1):
            if size(lpb) + _K2A_STATIC_SMEM > smem_block:
                continue
            threads = 32 * -(-lpb // lanes_per_warp)
            blocks = min(32, 2048 // threads,
                         smem_sm // (size(lpb) + _K2A_STATIC_SMEM
                                     + _SMEM_RESERVED))
            if best is None or lpb * blocks > best[1]:
                best = (lpb, lpb * blocks)
        if best is not None:
            return {"lpw": min(lanes_per_warp, best[0]), "lpb": best[0],
                    "lt": lt, "lanes_per_sm": best[1], "s_pad": s_pad,
                    "m_pad": m_pad, "smem": size(best[0]), "layout": lay}
    raise ValueError(f"K2a's layout {lay} needs {size(1) + _K2A_STATIC_SMEM} "
                     f"B of shared memory for S = {S} and {models_max} "
                     f"models a column, more than the card's {smem_block} B")


def _card_shape(lib, plan_t: dict, lmax: int,
                lanes_per_warp: int = LANES_PER_WARP,
                layout: int | None = None) -> dict:
    """``triples_shape`` on the current card's shared memory."""
    block, sm = _build.smem_limits()
    return triples_shape(plan_t["S"], plan_t["models_max"], lmax,
                         block, sm, lanes_per_warp, layout)


def card_layout(plan_t: dict, lmax: int) -> int:
    """The layout K2a takes for lanes of at most lmax lines of this plan
    on the current card (``triples_shape``)."""
    return _card_shape(_build.load(), plan_t, lmax)["layout"]


def code_lanes(plan_t: dict, mid: torch.Tensor, qs: torch.Tensor,
               lane_counts, base: int, clusters: torch.Tensor | None = None):
    """Code lane w = lines base + sum(lane_counts[:w]) onwards, for
    lane_counts[w] lines, from the (cols, N) int32 quantize outputs;
    clusters, the (N,) uint8 cluster ids of those lines on their device,
    or None with one cluster. Returns the raw lane output (words,
    n_words, carry). CPU tensors take the plain version; CUDA tensors
    launch K2s and K2b for the cluster-id segment, then K2a and K2b
    (csrc/coder.cu) over chunks of columns, K2a in the layout
    ``triples_shape`` picks for the card (every plan has one), or
    raise."""
    _check(plan_t, mid, qs, lane_counts, base, clusters)
    dev = mid.device
    W = len(lane_counts)
    if dev.type == "cpu":
        return encode_lanes_reference(plan_t, mid, qs, lane_counts, base,
                                      clusters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    L = int(max(lane_counts)) if W else 0
    max_steps = (mid.shape[0] + (clusters is not None)) * L
    max_words = -(-max_steps * BITS_PER_STEP_BOUND // 32) + 2
    return _compose(segment_triples, triples, chain, plan_t, mid.contiguous(),
                    qs.contiguous(), lane_counts, base, clusters,
                    start_raw(W, dev, max_words))


def _uses_scratch(shape: dict, W: int, dev) -> torch.Tensor | None:
    """Layout 2's device-memory uses: (s_pad + m_pad) u16 for each lane
    of each block (K2a's and K5's); None in the other layouts."""
    if shape["layout"] != 2:
        return None
    lanes = -(-W // shape["lpb"]) * shape["lpb"]
    return torch.empty(lanes * (shape["s_pad"] + shape["m_pad"]),
                       dtype=torch.int16, device=dev)


def triples(plan_t: dict, mid: torch.Tensor, qs: torch.Tensor, lane_counts,
            base: int, c0: int, c1: int,
            lanes_per_warp: int = LANES_PER_WARP,
            layout: int | None = None):
    """K2a over columns c0 .. c1 - 1: the triples as ``triples_reference``
    returns them. CPU tensors take the plain version; CUDA tensors launch
    K2a (csrc/coder.cu), lanes_per_warp lanes in each warp, in `layout`
    (``triples_shape``'s choice where None), with the lanes' records of
    the chunk's models at risk (``risk_tables``) in device memory where it
    has any, or raise."""
    _check(plan_t, mid, qs, lane_counts, base, None)
    if not 0 <= c0 < c1 <= mid.shape[0]:
        raise ValueError(f"columns {c0}..{c1} out of range")
    dev = mid.device
    if dev.type == "cpu":
        return triples_reference(plan_t, mid, qs, lane_counts, base, c0, c1)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load()
    W = len(lane_counts)
    L = int(max(lane_counts)) if W else 0
    S = plan_t["S"]
    shape = _card_shape(lib, plan_t, L, lanes_per_warp, layout)
    mid, qs = mid.contiguous(), qs.contiguous()
    offs = _lane_offsets(lane_counts, base, dev)
    trip = torch.empty(((c1 - c0) * L, W), dtype=torch.int64, device=dev)
    scratch = _uses_scratch(shape, W, dev)
    risk = risk_tables(plan_t, L)
    n_rec = int(risk["roff_h"][c1] - risk["roff_h"][c0])
    rec = (torch.empty(W * n_rec * 2, dtype=torch.int32, device=dev)
           if n_rec else None)
    _build.launch(
        "coder_triples", "lane coder triples kernel", dev,
        lib.qvz_coder_triples, mid.data_ptr(), qs.data_ptr(), mid.shape[1],
        offs.data_ptr(), W, c0, c1 - c0, L, plan_t["mloc"].data_ptr(),
        plan_t["mtab"].data_ptr(), plan_t["col_model_off"].data_ptr(),
        plan_t["init_counts"].data_ptr(), plan_t["init_prefix"].data_ptr(),
        plan_t["col_slots"].data_ptr(), S, trip.data_ptr(), shape["layout"],
        *_risk_args(risk, rec),
        scratch.data_ptr() if scratch is not None else None, shape["lpw"],
        shape["lpb"], shape["lt"], shape["s_pad"], shape["m_pad"],
        shape["smem"])
    return trip


def _risk_args(risk: dict, rec: torch.Tensor | None) -> tuple:
    """K2a's and K5's arguments for the records of the models at risk:
    (rescale, rbase, rsrc, roff, rec), all null without records."""
    if rec is None:
        return 0, None, None, None, None
    return (1, risk["rbase"].data_ptr(), risk["rsrc"].data_ptr(),
            risk["roff"].data_ptr(), rec.data_ptr())


def chain(trip: torch.Tensor, ncols: int, lane_counts, raw,
          lanes_per_warp: int = CHAIN_LANES_PER_WARP):
    """K2b over ncols columns of triples from the raw lane output `raw`:
    the contract of ``chain_reference``. CPU tensors take the plain
    version; CUDA tensors launch K2b (csrc/coder.cu), lanes_per_warp lanes
    in each warp, which writes the words, word counts and carry of `raw`
    in place (its words (W, max_words) int32 hold the room; a lane that
    would run past it is marked overrun in the carry), or raise."""
    dev = trip.device
    W = len(lane_counts)
    words, n_words, carry = raw
    if trip.dtype != torch.int64 or trip.dim() != 2 or trip.shape[1] != W \
            or ncols < 1 or trip.shape[0] % ncols:
        raise ValueError(f"trip must be (ncols * L, {W}) int64")
    if trip.shape[0] // ncols < int(max(lane_counts, default=0)):
        raise ValueError("lanes are longer than the triples' columns")
    if any(t.device != dev for t in raw):
        raise ValueError("triples and lane output must share one device")
    if dev.type == "cpu":
        return chain_reference(trip, ncols, lane_counts, raw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[0] != W or not words.is_contiguous() \
            or n_words.dtype != torch.int32 or n_words.shape != (W,) \
            or carry.dtype != torch.int64 or carry.shape != (6, W) \
            or not carry.is_contiguous():
        raise ValueError("raw must be (W, max_words) int32 words, (W,) "
                         "int32 counts and a contiguous (6, W) int64 carry")
    lib = _build.load()
    trip = trip.contiguous()
    offs = _lane_offsets(lane_counts, 0, dev)
    _build.launch("coder_chain", "lane coder chain kernel", dev,
                  lib.qvz_coder_chain, trip.data_ptr(), ncols,
                  trip.shape[0] // ncols, offs.data_ptr(), W,
                  words.data_ptr(), words.shape[1], n_words.data_ptr(),
                  carry.data_ptr(), lanes_per_warp)
    return raw


def finish_payload(words: np.ndarray, l: int, s3: int, buf: int,
                   cnt: int) -> bytes:
    """Assemble one lane's payload (copied from
    ``qvz_tpu.ops.coder_device.finish_payload``): packed words + pending
    bits + the encoder flush (msb of l, scale3 complements, low
    ARITH_M-1 bits of l — arith.c:99-115) + the reference's
    unconditional byte pad (os_stream.c:105-110: a stream ending on a
    byte boundary gains one extra zero byte)."""
    body = np.ascontiguousarray(words, dtype=np.uint32).astype(
        ">u4").tobytes()
    msb = (int(l) >> MSB_SHIFT) & 1
    comp = msb ^ 1
    v = int(buf)
    v = (v << 1) | msb
    v = (v << s3) | (((1 << s3) - 1) if comp else 0)
    v = (v << (ARITH_M - 1)) | (int(l) & ((1 << (ARITH_M - 1)) - 1))
    nb = int(cnt) + ARITH_M + int(s3)
    pad = 8 - (nb % 8)           # nb % 8 == 0 -> pad == 8 (extra byte)
    v <<= pad
    nb += pad
    return body + v.to_bytes(nb // 8, "big")


def fetch_lanes(words: torch.Tensor, n_words: torch.Tensor,
                carry: torch.Tensor):
    """Copy the used part of a raw lane output to the host: (words
    (W, max n_words) uint32, n_words, carry (6, W) int64) as numpy."""
    nw = n_words.cpu().numpy()
    used = int(nw.max()) if nw.size else 0
    w_h = words[:, :used].cpu().numpy().view(np.uint32)
    return w_h, nw, carry.cpu().numpy()


def payloads_from_raw(words_h, n_words_h, carry_h):
    """Per-lane payload bytes and the lanes' flags (qvz_tpu's contract;
    none is set: every lane is coded). A lane marked overrun, whose words
    passed the room ``code_lanes`` sized for them, raises RuntimeError."""
    flags = carry_h[5] != 0
    if flags.any():
        raise RuntimeError(
            f"K2b ran past the words of lanes {np.flatnonzero(flags)[:8]}: "
            f"more than {BITS_PER_STEP_BOUND} bits a step")
    payloads = [finish_payload(
        words_h[w, : n_words_h[w]], int(carry_h[0, w]), int(carry_h[2, w]),
        int(carry_h[3, w]), int(carry_h[4, w]))
        for w in range(len(n_words_h))]
    return payloads, flags


def wait_and_fetch(raw):
    """The host's end of ``code_lanes``: wait for the lanes of the raw
    output `raw` and copy them to the host. Returns ``fetch_lanes``'s
    arrays, which ``payloads_from_raw`` assembles, and the seconds of the
    device-to-host copy (fenced)."""
    if raw[0].device.type == "cuda":
        torch.cuda.synchronize(raw[0].device)
    t0 = time.perf_counter()
    fetched = fetch_lanes(*raw)
    return fetched, time.perf_counter() - t0


def encode_lanes_raw(plan_t: dict, mid: torch.Tensor, qs: torch.Tensor,
                     lane_counts, base: int,
                     clusters: torch.Tensor | None = None):
    """(payloads, flags) for the lanes of the (cols, N) quantize outputs:
    the contract of ``qvz_tpu.ops.coder_device.encode_lanes_raw``, but
    with the lines' (N,) uint8 cluster ids (None with one cluster) where
    qvz_tpu takes the host's cluster-id triples. Lane w covers lines base
    + sum(lane_counts[:w]) onwards. Every lane is coded, so no flag is
    set (``qvz_tpu`` flags a lane whose model would rescale and leaves it
    to the host). ``code_lanes``, ``wait_and_fetch``, then
    ``payloads_from_raw``."""
    fetched, _ = wait_and_fetch(
        code_lanes(plan_t, mid, qs, lane_counts, base, clusters))
    return payloads_from_raw(*fetched)
