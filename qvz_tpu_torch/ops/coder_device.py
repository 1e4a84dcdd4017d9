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

That module imports JAX when it loads, so the numpy parts the port needs
are copied here: the per-column slot layout of ``LanePlan`` and
``finish_payload``.

With more than one cluster (-c K > 1), each lane first codes its lines'
cluster ids, one step per line before column 0, with explicit triples
(cum_lo, cum_hi, total) that the caller replays exactly on the host
(``rt.replay_model``): the cluster-id segment.

Raw lane output, shared by K2 and its plain version:
  words   (W, max_words) int32  the lane's packed 32-bit words (u32 bits)
  n_words (W,) int32            how many of them are valid
  carry   (6, W) int64          l, u, scale3, pending bits, pending bit
                                count, flag
A flagged lane (a model would rescale, or an emission would pass 63 bits)
must be re-coded on the host; ``encode_lanes_raw`` returns None for it.
"""

from __future__ import annotations

import ctypes
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
        # card << 20 | initial total. A total is clamped below 2^20; any
        # total that high flags its lane at the model's first live step.
        mloc = np.zeros(n_models, dtype=np.int32)
        recs = []
        tot = np.minimum(totals_init.astype(np.int64), _TOTAL_MASK)
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
        "slot_base": t(plan.slot_base),
        "cards": t(plan.cards),
        "init_counts": t(plan.init_counts_cols),
        "init_prefix": t(plan.init_prefix_cols),
        "col_slots": t(plan.col_slots),
        "mloc": t(plan.mloc),
        "mtab": t(plan.mtab),
        "col_model_off": t(plan.col_model_off),
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


def _coder_step(l, u, s3, acc, nacc, flag, clo, chi, n):
    """One arithmetic-coder step across all lanes, in int64: the maths of
    ``qvz_tpu.ops.coder_device._coder_step`` (the host Encoder::step with
    batched E1*/E3* renormalisation). Returns the new state and the two
    (word, flushed) pairs of the step's bit packing."""
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
    flag = flag | (e1 & (k1 + s3 > 63))
    s3c = torch.minimum(s3, 63 - k1)
    nbits = torch.where(e1, k1 + s3c, 0)
    comp = torch.where(first == 0, ((1 << s3c) - 1) << k1m1, 0)
    v = (first << (nbits - 1).clamp(min=0)) | comp \
        | (top & ((1 << k1m1) - 1))
    v = torch.where(e1, v, 0)
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

    # Pack: bits >= 32 of the emission first, then the low 32.
    acc, nacc, w0, f0 = _put(acc, nacc, v >> 32, (nbits - 32).clamp(min=0))
    acc, nacc, w1, f1 = _put(acc, nacc, v & U32, nbits.clamp(max=32))
    return (l, u, s3, acc, nacc, flag), (w0, f0, w1, f1)


def pack_triples(cum_lo, cum_hi, total):
    """The int64 triple of three 20-bit fields that K2a writes."""
    return cum_lo | (cum_hi << FIELD_BITS) | (total << (2 * FIELD_BITS))


def segment_triples(cluster_triples: np.ndarray, lane_counts,
                    device) -> torch.Tensor:
    """The cluster-id segment, (W, L, 3) uint32 triples, as one column of
    K2b's step-major (L, W) int64 triples; 0 past a ragged lane's end."""
    ct = cluster_triples.astype(np.int64)
    valid = np.arange(ct.shape[1])[None, :] < np.asarray(
        lane_counts, dtype=np.int64)[:, None]
    t = np.where(valid, pack_triples(ct[..., 0], ct[..., 1], ct[..., 2]), 0)
    return torch.from_numpy(np.ascontiguousarray(t.T)).to(device)


def chunk_columns(cols: int, lanes: int, lmax: int) -> int:
    """Columns a chunk of K2a's triples holds within TRIPLE_BYTES (and
    K2a's grid: at most 65,535)."""
    return max(1, min(cols, 65535,
                      TRIPLE_BYTES // max(1, 8 * lanes * lmax)))


def start_raw(W: int, device, max_words: int = 0):
    """The raw lane output of lanes that have coded nothing yet, with room
    for max_words words a lane (K2b writes into it)."""
    carry = torch.zeros((6, W), dtype=torch.long, device=device)
    carry[1] = FULL
    return (torch.zeros((W, max_words), dtype=torch.int32, device=device),
            torch.zeros(W, dtype=torch.int32, device=device), carry)


def triples_reference(plan_t: dict, mid: torch.Tensor, qs: torch.Tensor,
                      lane_counts, base: int, c0: int, c1: int):
    """Plain PyTorch version of K2a over columns c0 .. c1 - 1: every
    (column, lane) in parallel, the steps in a loop. Returns the triples,
    (ncols * L, W) int64 with row cc * L + j for line j of column c0 + cc
    (L the longest lane; 0 where a step codes nothing), and (W,) bool, the
    lanes that would rescale. Once a lane would rescale in a column, it
    codes nothing more there, as in K2a."""
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
    col = torch.arange(nc, device=dev).repeat_interleave(W)       # (R,)
    mloc = plan_t["mloc"].long()[m]
    mtab = plan_t["mtab"].long()
    rec = mtab[(plan_t["col_model_off"].long()[c0 + col][:, None] + mloc)
               .clamp(max=max(len(mtab) - 1, 0))]                 # (R, L, 2)
    sb = rec[..., 0]
    card = rec[..., 1] >> _TOTAL_BITS
    tot0 = rec[..., 1] & _TOTAL_MASK
    live = (m > 0) & (card > 1)
    init = plan_t["init_counts"].long()[c0:c1].reshape(-1)
    ipre = plan_t["init_prefix"].long()[c0:c1].reshape(-1)
    row0 = col * S                             # a row's column in init/ipre

    occ = torch.zeros((R, S), dtype=torch.int32, device=dev)
    muse = torch.zeros((R, max(plan_t["models_max"], 1)), dtype=torch.int32,
                       device=dev)
    flagged = torch.zeros(R, dtype=torch.bool, device=dev)
    ar = torch.arange(A, device=dev)
    ar_r = torch.arange(R, device=dev)
    out = torch.zeros((L, R), dtype=torch.long, device=dev)
    for t in range(L):
        mlt, sbt, xt = mloc[:, t], sb[:, t], x[:, t]
        lv = live[:, t] & ~flagged
        total = tot0[:, t] + STEP * muse[ar_r, mlt].long()
        resc = lv & (total + STEP > ARITH_R)
        flagged |= resc
        lv &= ~resc
        g = occ.gather(1, (sbt[:, None] + ar).clamp(max=S - 1)).long()
        below = (g * (ar < xt[:, None])).sum(1)
        s = (sbt + xt).clamp(max=S - 1)
        cum_lo = ipre[row0 + s] + STEP * below
        cum_hi = cum_lo + init[row0 + s] + STEP * occ[ar_r, s].long()
        occ[ar_r, s] += lv.int()
        muse[ar_r, mlt] += lv.int()
        out[t] = torch.where(lv, pack_triples(cum_lo, cum_hi, total), 0)
    trip = out.reshape(L, nc, W).permute(1, 0, 2).reshape(nc * L, W)
    return trip, flagged.reshape(nc, W).any(0)


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
    flag = carry[5] != 0
    lens = torch.as_tensor(np.asarray(lane_counts, dtype=np.int64),
                           device=dev)
    words, flushes = [], []
    for cc in range(ncols):
        for j in range(L):
            t = trip[cc * L + j]
            lv = (j < lens) & ((t >> (2 * FIELD_BITS)) != 0)
            # a step that codes nothing takes the no-op triple (0, 1, 1)
            (l, u, s3, acc, nacc, flag), (w0, f0, w1, f1) = _coder_step(
                l, u, s3, acc, nacc, flag,
                torch.where(lv, t & FIELD_MASK, 0),
                torch.where(lv, (t >> FIELD_BITS) & FIELD_MASK, 1),
                torch.where(lv, t >> (2 * FIELD_BITS), 1))
            words.extend((w0, w1))
            flushes.extend((f0, f1))

    carry = torch.stack([l, u, s3, acc, nacc, flag.long()])
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
                           cluster_triples: np.ndarray | None = None):
    """Plain PyTorch version of K2: the cluster-id segment first when
    cluster_triples is given, then ``triples_reference`` and
    ``chain_reference`` over chunks of ``chunk_columns`` columns, as
    ``code_lanes`` launches K2a and K2b. Returns the raw lane output
    (words, n_words, carry) described in the module docstring."""
    return _compose(triples_reference, chain_reference, plan_t, mid, qs,
                    lane_counts, base, cluster_triples,
                    start_raw(len(lane_counts), mid.device))


def _compose(triples_fn, chain_fn, plan_t, mid, qs, lane_counts, base,
             cluster_triples, raw):
    """K2 from its two parts: the segment's chain, then each chunk's
    triples (their rescale flags into the carry) and chain."""
    cols = mid.shape[0]
    W = len(lane_counts)
    L = int(max(lane_counts)) if W else 0
    if cluster_triples is not None:
        raw = chain_fn(segment_triples(cluster_triples, lane_counts,
                                       mid.device), 1, lane_counts, raw)
    k = chunk_columns(cols, W, L)
    for c0 in range(0, cols, k):
        c1 = min(cols, c0 + k)
        trip, resc = triples_fn(plan_t, mid, qs, lane_counts, base, c0, c1)
        raw[2][5] |= resc.long()
        raw = chain_fn(trip, c1 - c0, lane_counts, raw)
    return raw


def _check(plan_t, mid, qs, lane_counts, base, cluster_triples):
    if cluster_triples is not None:
        want = (len(lane_counts), int(max(lane_counts)), 3)
        if cluster_triples.dtype != np.uint32 \
                or cluster_triples.shape != want:
            raise ValueError(f"cluster_triples must be {want} uint32")
        if cluster_triples.size and int(cluster_triples.max()) > FIELD_MASK:
            raise ValueError("cluster_triples must be below 2^20")
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
    block, sm = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib.qvz_coder_smem_limits(ctypes.byref(block),
                                           ctypes.byref(sm)),
                 "shared memory query")
    return triples_shape(plan_t["S"], plan_t["models_max"], lmax,
                         block.value, sm.value, lanes_per_warp, layout)


def card_layout(plan_t: dict, lmax: int) -> int:
    """The layout K2a takes for lanes of at most lmax lines of this plan
    on the current card (``triples_shape``)."""
    return _card_shape(_build.load(), plan_t, lmax)["layout"]


def code_lanes(plan_t: dict, mid: torch.Tensor, qs: torch.Tensor,
               lane_counts, base: int,
               cluster_triples: np.ndarray | None = None):
    """Code lane w = lines base + sum(lane_counts[:w]) onwards, for
    lane_counts[w] lines, from the (cols, N) int32 quantize outputs;
    cluster_triples, (W, max lane count, 3) uint32 or None, are the
    lanes' cluster-id steps. Returns the raw lane output (words, n_words,
    carry). CPU tensors take the plain version; CUDA tensors launch K2a
    and K2b (csrc/coder.cu) over chunks of columns, K2a in the layout
    ``triples_shape`` picks for the card (every plan has one), or
    raise."""
    _check(plan_t, mid, qs, lane_counts, base, cluster_triples)
    dev = mid.device
    W = len(lane_counts)
    if dev.type == "cpu":
        return encode_lanes_reference(plan_t, mid, qs, lane_counts, base,
                                      cluster_triples)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    L = int(max(lane_counts)) if W else 0
    max_steps = (mid.shape[0] + (cluster_triples is not None)) * L
    max_words = -(-max_steps * BITS_PER_STEP_BOUND // 32) + 2
    return _compose(triples, chain, plan_t, mid.contiguous(),
                    qs.contiguous(), lane_counts, base, cluster_triples,
                    start_raw(W, dev, max_words))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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
    """K2a over columns c0 .. c1 - 1: (triples, rescale flags) as
    ``triples_reference`` returns them. CPU tensors take the plain
    version; CUDA tensors launch K2a (csrc/coder.cu), lanes_per_warp
    lanes in each warp, in `layout` (``triples_shape``'s choice where
    None), or raise."""
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
    resc = torch.zeros(W, dtype=torch.int64, device=dev)
    scratch = _uses_scratch(shape, W, dev)
    rc = lib.qvz_coder_triples(
        mid.data_ptr(), qs.data_ptr(), mid.shape[1], offs.data_ptr(), W, c0,
        c1 - c0, L, plan_t["mloc"].data_ptr(), plan_t["mtab"].data_ptr(),
        plan_t["col_model_off"].data_ptr(), plan_t["init_counts"].data_ptr(),
        plan_t["init_prefix"].data_ptr(), plan_t["col_slots"].data_ptr(), S,
        trip.data_ptr(), resc.data_ptr(), shape["layout"],
        scratch.data_ptr() if scratch is not None else None, shape["lpw"],
        shape["lpb"], shape["lt"], shape["s_pad"], shape["m_pad"],
        shape["smem"], _stream(dev))
    _build.check(rc, "lane coder triples kernel")
    _build.LAUNCHES["coder_triples"] += 1
    return trip, resc != 0


def chain(trip: torch.Tensor, ncols: int, lane_counts, raw,
          lanes_per_warp: int = CHAIN_LANES_PER_WARP):
    """K2b over ncols columns of triples from the raw lane output `raw`:
    the contract of ``chain_reference``. CPU tensors take the plain
    version; CUDA tensors launch K2b (csrc/coder.cu), lanes_per_warp lanes
    in each warp, which writes the words, word counts and carry of `raw`
    in place (its words (W, max_words) int32 hold the room; a lane that
    runs past it is flagged), or raise."""
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
    rc = lib.qvz_coder_chain(trip.data_ptr(), ncols, trip.shape[0] // ncols,
                             offs.data_ptr(), W, words.data_ptr(),
                             words.shape[1], n_words.data_ptr(),
                             carry.data_ptr(), lanes_per_warp,
                             _stream(dev))
    _build.check(rc, "lane coder chain kernel")
    _build.LAUNCHES["coder_chain"] += 1
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
    """Per-lane payload bytes (None for a flagged lane) and the flags."""
    flags = carry_h[5] != 0
    payloads = []
    for w in range(len(n_words_h)):
        if flags[w]:
            payloads.append(None)
            continue
        payloads.append(finish_payload(
            words_h[w, : n_words_h[w]], int(carry_h[0, w]),
            int(carry_h[2, w]), int(carry_h[3, w]), int(carry_h[4, w])))
    return payloads, flags


def encode_lanes_raw(plan_t: dict, mid: torch.Tensor, qs: torch.Tensor,
                     lane_counts, base: int,
                     cluster_triples: np.ndarray | None = None,
                     stats: dict | None = None):
    """(payloads, flags) for the lanes of the (cols, N) quantize outputs:
    the contract of ``qvz_tpu.ops.coder_device.encode_lanes_raw``. Lane w
    covers lines base + sum(lane_counts[:w]) onwards; cluster_triples
    (W, max lane count, 3) uint32 are its cluster-id steps, None with one
    cluster. payloads[w] is None where flags[w] is set and the caller
    must re-code that lane on the host. stats, if given, gets the seconds
    of the device-to-host copy under "d2h" (fenced)."""
    raw = code_lanes(plan_t, mid, qs, lane_counts, base, cluster_triples)
    if mid.device.type == "cuda":
        torch.cuda.synchronize(mid.device)
    t0 = time.perf_counter()
    fetched = fetch_lanes(*raw)
    if stats is not None:
        stats["d2h"] = time.perf_counter() - t0
    return payloads_from_raw(*fetched)
