"""Lane-parallel adaptive arithmetic decoder on the device.

Counterpart of ``qvz_tpu.ops.decoder_device``; the CUDA kernel K5
(``csrc/decoder.cu``) replaces ``qvz_tpu.ops.decoder_pallas._dkernel``.

In column-major symbol order the model of step (column c, line i) depends
only on the symbol decoded at (c - 1, i), the line's cluster id and the
dither draw, none of which depends on the coder's interval. So every QVZ2
shard after the warmup shard decodes as an independent lane. Each step is
the host ``Decoder::step`` (qvz_rt.cpp): the tag check, the linear
boundary search cum*range < (t - l + 1)*n, the exact interval update and
the batched E1*/E3* renormalisation that consumes stream bits MSB-first
from the payload bytes, zero-filled past the end. The model counts are
reset from the initial bank at each column start and take +8 per live
(cardinality > 1) step, and a model whose total passes 2^19 rescales as
the host's ModelBank::update (every count c becomes (c >> 1) + 1): K5
keeps the counts of the models at risk (``coder_device.risk_tables``) in
a record of each lane's own in device memory. A card-1 model moves
neither the interval nor a bit. The last symbol of a shard runs as a
normal step: its extra renormalisation only changes state that is thrown
away.

Before K5, K5p (``cluster_prologue``, plain version
``cluster_prologue_reference``) starts every lane on the device, one
thread a lane: with more than one cluster it decodes the lane's cluster
ids with the cluster-id model (model 0, updated once a line, rescale
included) as the host's ``rt.decode_cluster_prologue`` does, into the ids
K5 reads, and writes the state where K5 resumes; with one cluster that
state is the full interval and the payload's first 22 bits.

Flags (bits of a lane's flag word), as ``qvz_tpu``'s decoder: 1 bad (the
tag left [l, u], or a context is unreachable), 4 overrun (the lane
consumed more than 64 bytes past its payload: the host
``BitReader::overrun`` rule, on consumed bits), and K5p's 1 (the tag left
[l, u] in the prologue) and 8 (a cluster id at or past the cluster
count), where the host's prologue fails with -3 and -1; K5 decodes no
step of a lane K5p flagged. Only a corrupt stream sets them; such a lane
is decoded again on the host, whose error or output is the outcome.
``qvz_tpu``'s decoder also flags a lane that reaches a rescale (2); K5
decodes it.

Lane w decodes lines base + sum(lane_counts[:w]) onwards, for
lane_counts[w] lines, of the (cols, N) draws and (N,) cluster ids; its
rows go to ``out[line, :cols] = qv + sym_add``, and a newline to
``out[line, cols]`` where ``out`` has a column more. Its final state is
one row of (l, u, t, consumed bits, flags).

``DecodePlan`` is copied from ``qvz_tpu.ops.decoder_device`` (that module
imports JAX when it loads), without its Mosaic-packed tables, and takes
from ``coder_device.LanePlan`` the per-column model records that K5 (and
K2a) read.

K5 decodes LANES_PER_WARP lanes in each warp (``lanes_per_warp``; up to 32
lanes a block): fewer lanes a warp serialise fewer divergent steps and let
an SM interleave more warps. It takes every plan: where the column's
tables do not fit a block's shared memory beside one lane's uses, it
reads them from device memory, and where the uses alone do not fit, keeps
those there too (``launch_shape``'s layout).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qvz_tpu_torch import _build
from qvz_tpu_torch.device import resolve
from qvz_tpu_torch.ops.coder_device import (ARITH_M, ARITH_R, FULL,
                                            LAYOUTS, MSB_BIT, MSB_CLEAR,
                                            MSB_SHIFT, SMSB_SHIFT, STEP, U32,
                                            _bit_length, _lane_offsets,
                                            _risk_args, _round8,
                                            _uses_scratch, plan_to_torch,
                                            risk_tables)

FLAG_BAD, FLAG_OVERRUN, FLAG_CLUSTER = 1, 4, 8
OVERRUN_BYTES = 64       # the host BitReader's margin past the payload
A = 72                   # no model has more symbols than the alphabet
# K5's launch shape: lanes decoded in each warp, and at most 32 lanes a
# block (2 was the fastest of 32, 16, 8, 4, 2 and 1 on an H100, PERF.md)
LANES_PER_WARP = 2
_LANES_PER_BLOCK = 32
_CHUNK_CAP = 2048        # K5's steps a chunk, at most
PROLOGUE_LANES_PER_BLOCK = 32   # K5p's lanes (threads) a block


class DecodePlan:
    """Per-(tables, init bank) lookup tables of the lane decoder, over
    ``coder_device.LanePlan``'s slot layout:
      ptab   (cols, n_cl*72) int32  pair index for (cluster, previous
             symbol), -1 where the context is unreachable;
      qrtab  (n_pairs,) int32       dither thresholds;
      symtab (cols, S) int32        the symbol value of each slot;
      mloc   (n_models,) int32      a model's index among its column's
             models (col_models order);
      mtab   (n_models - 1, 2) int32  each column's model records, from
             col_model_off[c]: slot base, card << 20 | initial total;
      col_model_off (cols + 1,) int32."""

    def __init__(self, plan, tables):
        cols, S = plan.columns, plan.S
        n_cl = plan.n_clusters
        moff = np.asarray(tables.model_off, dtype=np.int64)
        msyms = np.asarray(tables.model_syms, dtype=np.uint8)
        symtab = np.zeros((cols, S), dtype=np.int32)
        for c, ms in enumerate(plan.col_models):
            if len(ms):
                idx = np.concatenate([moff[m] + np.arange(plan.cards[m])
                                      for m in ms])
                symtab[c, : len(idx)] = msyms[idx]

        pair_base = np.asarray(tables.pair_base,
                               dtype=np.int64).reshape(n_cl, cols)
        ctxmap = np.asarray(tables.ctxmap,
                            dtype=np.int64).reshape(n_cl, cols, 72)
        ptab = np.where(ctxmap >= 0, pair_base[:, :, None] + ctxmap, -1)
        self.ptab = np.ascontiguousarray(
            np.transpose(ptab, (1, 0, 2)).reshape(cols, n_cl * 72)
        ).astype(np.int32)
        self.qrtab = np.asarray(tables.qratio).astype(np.int32)
        self.symtab = symtab
        # the lane coder's per-column model records
        self.mloc = plan.mloc
        self.mtab = plan.mtab
        self.col_model_off = plan.col_model_off
        self.plan = plan
        self.columns = cols
        self.S = S
        self.n_clusters = n_cl


def decode_plan_to_torch(dplan: DecodePlan, device) -> dict:
    """The plan's tables as int32 tensors on `device` (plan_to_torch's
    and ptab, qrtab, symtab)."""
    d = plan_to_torch(dplan.plan, device)
    for k in ("ptab", "qrtab", "symtab"):
        d[k] = torch.from_numpy(np.array(getattr(dplan, k), dtype=np.int32,
                                         copy=True)).to(device)
    d["n_clusters"] = int(dplan.n_clusters)
    return d


class LanePayloads(NamedTuple):
    """The lanes' payload bytes, packed into one flat buffer, zero-padded
    so that K5's aligned 8-byte loads stay inside it."""
    flat: torch.Tensor   # (P,) uint8
    off: torch.Tensor    # (W,) int64, where lane w's bytes start
    len: torch.Tensor    # (W,) int64
    lens: np.ndarray     # (W,) int64, the lengths on the host


def pack_payloads(payloads, device) -> LanePayloads:
    lens = np.fromiter((len(p) for p in payloads), dtype=np.int64,
                       count=len(payloads))
    flat = np.zeros(_padded_len(int(lens.sum())), dtype=np.uint8)
    flat[: int(lens.sum())] = np.frombuffer(
        b"".join(bytes(p) for p in payloads), dtype=np.uint8)
    return LanePayloads(torch.from_numpy(flat).to(device),
                        torch.from_numpy(np.cumsum(lens) - lens).to(device),
                        torch.from_numpy(lens).to(device), lens)


def _padded_len(nbytes: int) -> int:
    """The packed buffer's length: whole 8-byte words and one more."""
    return -(-nbytes // 8) * 8 + 8


def start_state(payload) -> tuple:
    """(l, u, t, consumed bits) where a lane without a cluster-id
    prologue starts: the full interval and the first 22 bits."""
    w0 = int.from_bytes(bytes(payload[:4]).ljust(4, b"\0"), "big")
    return 0, FULL, w0 >> (32 - ARITH_M), ARITH_M


def _bit_source(pays: LanePayloads, dev):
    """getk(B, k): each lane's next k (0..48) bits at bit position B (a
    (W,) tensor), MSB first, and B + k; zero past a payload's end (the
    host BitReader's zero fill)."""
    src = torch.cat([pays.flat, pays.flat.new_zeros(1)]).long()
    j = torch.arange(int(pays.lens.max(initial=0)) + 4, device=dev)
    pm = torch.where(j[None] < pays.len[:, None],
                     src[(pays.off[:, None] + j).clamp(max=src.numel() - 1)],
                     0)
    ar7 = torch.arange(7, device=dev)
    shifts = torch.arange(48, -1, -8, device=dev)

    def getk(B, k):
        idx = ((B >> 3)[:, None] + ar7).clamp(max=pm.shape[1] - 1)
        word = (pm.gather(1, idx) << shifts).sum(1)
        return (word >> (56 - (B & 7) - k)) & ((1 << k) - 1), B + k

    return getk


def _renormalise(l, u, t, B, upd, getk, wrap: bool = False):
    """The batched E1*/E3* renormalisation of the lanes where `upd`, the
    tag taking k1 stream bits, then k3 and one final MSB flip (k1 = 0 and
    k3 = 0 where a batch does not run); both batches' shifts follow from
    (l, u) alone, so one read serves them. With `wrap`, l and u are taken
    to 22 bits after the E1* batch where it does not run too, as the
    host's Decoder::step does (a bound past 22 bits follows only from a
    bank whose total is not its counts' sum)."""
    diff = l ^ u
    e1 = upd & ((diff >> MSB_SHIFT) == 0)
    k1 = torch.where(e1, ARITH_M - _bit_length(diff), 0)
    l = torch.where(e1 | wrap, (l << k1) & FULL, l)
    u = torch.where(e1 | wrap, ((u << k1) | ((1 << k1) - 1)) & FULL, u)

    e3 = upd & ((l >> SMSB_SHIFT) == 1) & ((u >> SMSB_SHIFT) == 2)
    lx = (l << (32 - SMSB_SHIFT)) & U32
    ux = (u << (32 - SMSB_SHIFT)) & U32
    lrun = 32 - _bit_length((~lx | 1) & U32)
    zrun = 32 - _bit_length(ux)
    k3 = torch.where(e3, 1 + torch.minimum(lrun, zrun), 0)
    l = torch.where(e3, (l << k3) & MSB_CLEAR, l)
    u = torch.where(e3, ((u << k3) & MSB_CLEAR) | MSB_BIT
                    | ((1 << k3) - 1), u)

    v, B = getk(B, k1 + k3)
    t = ((t << k1) | (v >> k3)) & FULL
    t = (((t << k3) | (v & ((1 << k3) - 1))) & FULL) \
        ^ torch.where(e3, MSB_BIT, 0)
    return l, u, t, B


def cluster_prologue_reference(dplan_t: dict, pays: LanePayloads,
                               lane_counts):
    """Plain PyTorch version of K5p, vectorised over lanes in int64: each
    lane's start at bit 0 (the full interval, the first 22 bits), then,
    with more than one cluster, its lane_counts[w] cluster ids decoded
    with the cluster-id model from the plan's cluster_init counts and
    cluster_total, each step the host's Decoder::step and
    ModelBank::update (``rt.decode_cluster_prologue``). Returns (cl, the
    (N,) uint8 ids, lane w's at lines sum(lane_counts[:w]) onwards (N the
    lanes' lines), None with one cluster; states, (W, 4) int64 (l, u,
    t, consumed bits) where K5 resumes; flags, (W,) int64: FLAG_BAD where
    the tag left [l, u] at a step's start, FLAG_CLUSTER where an id would
    pass the cluster count, 0 else). A flagged lane stops at that step: no
    later id of it is written (0) and its state stays."""
    dev = pays.flat.device
    W = len(lane_counts)
    c = dplan_t["cluster_init"].to(dev).long().expand(W, -1).clone()
    card = c.shape[1]
    getk = _bit_source(pays, dev)
    zero = torch.zeros(W, dtype=torch.long, device=dev)
    t, B = getk(zero, ARITH_M)
    l, u = zero.clone(), torch.full((W,), FULL, dtype=torch.long,
                                    device=dev)
    flags = zero.clone()
    offs = _lane_offsets(lane_counts, 0, dev)
    lens = offs[1:] - offs[:-1]
    if card < 2:
        return None, torch.stack([l, u, t, B], 1), flags
    cl = torch.zeros(int(np.sum(lane_counts)), dtype=torch.uint8,
                     device=dev)
    total = torch.full((W,), dplan_t["cluster_total"], dtype=torch.long,
                       device=dev)
    ar_w = torch.arange(W, device=dev)
    for i in range(int(lens.max()) if W else 0):
        live = (i < lens) & (flags == 0)
        bad = live & ((t < l) | (t > u))
        flags |= bad.long() * FLAG_BAD
        live &= ~bad
        rng = u - l + 1
        cum = c.cumsum(1)
        # the first x with cum_x * range >= (t - l + 1) * total; card where
        # there is none (the host's search runs past model 0)
        x = (cum * rng[:, None] < ((t - l + 1) * total)[:, None]).sum(1)
        over = live & (x >= card)
        flags |= over.long() * FLAG_CLUSTER
        live &= ~over
        x = x.clamp(max=card - 1)
        cl[(offs[:-1] + i)[live]] = x[live].to(torch.uint8)
        cum_hi = cum[ar_w, x]
        cum_lo = cum_hi - c[ar_w, x]
        tot = total.clamp(min=1)
        nu = (l + rng * cum_hi // tot - 1) & U32
        nl = (l + rng * cum_lo // tot) & U32
        c[ar_w, x] += STEP * live
        n = total + STEP
        resc = live & (n > ARITH_R)
        if bool(resc.any()):
            # every nonzero count becomes (c >> 1) + 1, the total their sum
            h = torch.where(c != 0, (c >> 1) + 1, 0)
            c = torch.where(resc[:, None], h, c)
            n = torch.where(resc, h.sum(1), n)
        total = torch.where(live, n, total)
        l2, u2, t2, B2 = _renormalise(nl, nu, t, B, live, getk, wrap=True)
        l, u = torch.where(live, l2, l), torch.where(live, u2, u)
        t, B = torch.where(live, t2, t), torch.where(live, B2, B)
    return cl, torch.stack([l, u, t, B], 1), flags


def cluster_prologue(dplan_t: dict, pays: LanePayloads, lane_counts):
    """K5p: every lane's start, as ``cluster_prologue_reference`` returns
    it (cl, states, flags). CPU tensors take the plain version; CUDA
    tensors launch K5p (csrc/decoder.cu), one thread a lane, or raise."""
    W = len(lane_counts)
    if pays.off.shape != (W,) or len(pays.lens) != W:
        raise ValueError(f"payloads must be {W} lanes")
    dev = pays.flat.device
    if dev.type == "cpu":
        return cluster_prologue_reference(dplan_t, pays, lane_counts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load()
    init = dplan_t["cluster_init"]
    card = init.numel()
    offs = _lane_offsets(lane_counts, 0, dev)
    cl = (torch.zeros(int(np.sum(lane_counts)), dtype=torch.uint8,
                      device=dev) if card > 1 else None)
    states = torch.empty((W, 4), dtype=torch.int64, device=dev)
    flags = torch.empty(W, dtype=torch.int64, device=dev)
    _build.launch(
        "cluster_prologue", "cluster-id prologue kernel", dev,
        lib.qvz_cluster_prologue, _packed_words(pays).data_ptr(),
        pays.off.data_ptr(), pays.len.data_ptr(), offs.data_ptr(), W,
        init.data_ptr(), card, dplan_t["cluster_total"],
        cl.data_ptr() if cl is not None else None, states.data_ptr(),
        flags.data_ptr(), PROLOGUE_LANES_PER_BLOCK)
    return cl, states, flags


def _packed_words(pays: LanePayloads) -> torch.Tensor:
    """The packed payloads as the kernels read them: 8-byte aligned, in
    whole words and one more (a copy where ``pays.flat`` is not)."""
    flat = pays.flat
    padded = _padded_len(int(pays.lens.sum()))
    if flat.data_ptr() % 8 or flat.numel() < padded:
        flat = torch.zeros(padded, dtype=torch.uint8, device=flat.device)
        flat[: pays.flat.numel()] = pays.flat
    return flat


def decode_lanes_reference(dplan_t: dict, pays: LanePayloads,
                           draws_t: torch.Tensor, cl: torch.Tensor | None,
                           lane_counts, base: int, states: torch.Tensor,
                           out: torch.Tensor, sym_add: int = 0,
                           cols_run: int | None = None,
                           start_flags: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of K5: the per-step loop vectorised over
    lanes, in int64. Arguments and result as ``decode_lanes_t``."""
    dev = draws_t.device
    cols = dplan_t["columns"]
    cols_run = cols if cols_run is None else cols_run
    S = dplan_t["S"]
    W = len(lane_counts)
    L = int(max(lane_counts)) if W else 0
    slot_base = dplan_t["slot_base"].long()
    cards = dplan_t["cards"].long()
    init_counts = dplan_t["init_counts"].long()
    ptab = dplan_t["ptab"].long()
    qrtab = dplan_t["qrtab"].long()
    symtab = dplan_t["symtab"].long()
    getk = _bit_source(pays, dev)

    offs = _lane_offsets(lane_counts, base, dev)
    lens = offs[1:] - offs[:-1]
    if start_flags is not None:    # a lane K5p flagged decodes no step
        lens = torch.where(start_flags != 0, 0, lens)
    i_ar = torch.arange(L, device=dev)
    lvalid = i_ar[None] < lens[:, None]                             # (W, L)
    line = torch.where(lvalid, offs[:-1, None] + i_ar, offs[:-1, None])
    line = line.clamp(max=max(draws_t.shape[1] - 1, 0))
    clw = cl[line].long() if cl is not None else torch.zeros_like(line)
    st = states.long()
    l, u, t, B = (st[:, k].clone() for k in range(4))
    bad = torch.zeros(W, dtype=torch.bool, device=dev)
    prev = torch.zeros((W, L), dtype=torch.long, device=dev)
    ar = torch.arange(A, device=dev)
    ar_w = torch.arange(W, device=dev)
    rows = line[lvalid]

    for c in range(cols_run):
        # model resolution for the whole column (the previous column's
        # symbols are all known)
        p = ptab[c][clw * 72 + prev]
        bad |= (lvalid & (p < 0)).any(1)
        p = p.clamp(min=0)
        m = 1 + 2 * p + (draws_t[c][line].long() >= qrtab[p]).long()
        sb, card = slot_base[m], cards[m]
        live = lvalid & (card > 1)
        counts = init_counts[c].expand(W, S).clone()
        xs = torch.zeros((W, L), dtype=torch.long, device=dev)
        for i in range(L):
            bad |= lvalid[:, i] & ((t < l) | (t > u))
            upd, sbi, cdi = live[:, i], sb[:, i], card[:, i]
            g = counts.gather(1, (sbi[:, None] + ar).clamp(max=S - 1))
            g = torch.where(ar < cdi[:, None], g, 0)
            cum = g.cumsum(1)
            n = torch.where(upd, cum[:, -1], 1)
            rng = u - l + 1
            # first k with cum_k*range >= (t - l + 1)*n; past the model's
            # last symbol only where the tag left [l, u]
            x = ((cum * rng[:, None] < ((t - l + 1) * n)[:, None])
                 & (ar < cdi[:, None])).sum(1)
            bad |= upd & (x >= cdi)
            x = torch.where(upd, torch.minimum(x, cdi - 1), 0)
            cum_hi = cum.gather(1, x[:, None])[:, 0]
            cum_lo = cum_hi - g.gather(1, x[:, None])[:, 0]
            counts[ar_w, (sbi + x).clamp(max=S - 1)] += STEP * upd
            resc = upd & (n + STEP > ARITH_R)
            if bool(resc.any()):
                # every count of the model becomes (c >> 1) + 1
                rr = resc.nonzero()[:, 0]
                slots = (sbi[rr, None] + ar).clamp(max=S - 1)
                inm = ar < cdi[rr, None]
                h = (counts[rr[:, None], slots] >> 1) + 1
                counts[rr[:, None].expand_as(slots)[inm], slots[inm]] = \
                    h[inm]
            u = torch.where(upd, (l + rng * cum_hi // n - 1) & U32, u)
            l = torch.where(upd, l + rng * cum_lo // n, l)
            l, u, t, B = _renormalise(l, u, t, B, upd, getk)
            xs[:, i] = x
        prev = symtab[c][(sb + xs).clamp(max=S - 1)]
        out[rows, c] = (prev[lvalid] + sym_add).to(out.dtype)
    if cols_run and out.shape[1] > cols:
        out[rows, cols] = ord("\n")
    over = B > 8 * (pays.len + OVERRUN_BYTES)
    flags = (bad.long() * FLAG_BAD) | (over.long() * FLAG_OVERRUN)
    if start_flags is not None:
        flags |= start_flags
    return torch.stack([l, u, t, B, flags], 1)


def _check(dplan_t, pays, draws_t, cl, lane_counts, base, states, out,
           cols_run, start_flags):
    cols = dplan_t["columns"]
    W = len(lane_counts)
    if pays.flat.dtype != torch.uint8 or pays.off.shape != (W,) \
            or pays.len.shape != (W,) or len(pays.lens) != W:
        raise ValueError(f"payloads must be {W} lanes of uint8")
    if int(pays.lens.sum()) > pays.flat.numel():
        raise ValueError("payload lengths run past the packed buffer")
    if draws_t.dtype != torch.uint8 or draws_t.dim() != 2 \
            or draws_t.shape[0] != cols:
        raise ValueError(f"draws_t must be ({cols}, N) uint8")
    n = draws_t.shape[1]
    if cl is not None and (cl.dtype != torch.uint8 or cl.shape != (n,)):
        raise ValueError(f"cluster ids must be ({n},) uint8")
    if base < 0 or base + int(np.sum(lane_counts)) > n:
        raise ValueError("lanes run past the draws")
    if states.dtype != torch.int64 or states.shape != (W, 4):
        raise ValueError(f"states must be ({W}, 4) int64")
    if out.dtype != torch.uint8 or out.dim() != 2 or out.shape[0] != n \
            or out.shape[1] < cols:
        raise ValueError(f"out must be ({n}, >= {cols}) uint8")
    if cols_run is not None and not 0 <= cols_run <= cols:
        raise ValueError(f"cols_run must be in [0, {cols}]")
    if start_flags is not None and (start_flags.dtype != torch.int64
                                    or start_flags.shape != (W,)):
        raise ValueError(f"start_flags must be ({W},) int64")
    dev = draws_t.device
    tensors = [pays.flat, pays.off, pays.len, states, out,
               dplan_t["init_counts"]] + ([cl] if cl is not None else []) \
        + ([start_flags] if start_flags is not None else [])
    if any(x.device != dev for x in tensors):
        raise ValueError("inputs and plan must share one device")


def launch_shape(S: int, models_max: int, lmax: int, ptab_w: int,
                 lanes_per_warp: int, smem_limit: int,
                 layout: int | None = None) -> dict:
    """K5's block shape and dynamic shared memory for a plan of S slots
    and at most models_max models a column, lanes of at most lmax lines:
    lanes_per_warp lanes decode in each warp, a block holds 32 lanes in
    32 / lanes_per_warp warps, and a chunk of up to 2048 steps; chunk,
    then lanes, shrink until the layout of csrc/decoder.cu fits
    smem_limit bytes. The layout is the first of LAYOUTS in which one
    lane fits, or `layout` where given (which raises if even one lane
    does not fit it): 0 stages the column's tables and keeps each lane's
    uses in shared memory, 1 reads the tables from device memory, 2 keeps
    the uses there too."""
    if lanes_per_warp not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes_per_warp {lanes_per_warp} is not a power "
                         "of two up to 32")
    if models_max > 1 << 16:
        raise ValueError(f"{models_max} models in a column; K5 takes at "
                         "most 65536")
    s_pad, m_pad = _round8(max(S, 1)), _round8(max(models_max, 1))
    tables = (m_pad * 8 + s_pad * 4 + ptab_w * 4 + s_pad, 0, 0)
    uses = ((s_pad + m_pad) * 2,) * 2 + (0,)

    for lay in LAYOUTS if layout is None else (layout,):
        def size(lpb, lt):
            return tables[lay] + lpb * (uses[lay] + lt * 3)

        lpb = _LANES_PER_BLOCK
        lt = _round8(max(1, min(lmax, _CHUNK_CAP)))
        while size(lpb, lt) > smem_limit:
            if lt > 256:
                lt = max(256, _round8(lt // 2))
            elif lpb > 1:
                lpb //= 2
            elif lt > 8:
                lt = _round8(lt // 2)
            else:
                break
        if size(lpb, lt) <= smem_limit:
            return {"lpw": min(lanes_per_warp, lpb), "lpb": lpb, "lt": lt,
                    "s_pad": s_pad, "m_pad": m_pad, "smem": size(lpb, lt),
                    "layout": lay}
    raise ValueError(f"K5's layout {lay} needs {size(1, 8)} B of shared "
                     f"memory for S = {S}, more than the card's "
                     f"{smem_limit} B")


def _card_shape(lib, dplan_t: dict, lmax: int, lanes_per_warp: int,
                layout: int | None = None) -> dict:
    return launch_shape(dplan_t["S"], dplan_t["models_max"], lmax,
                        dplan_t["ptab"].shape[1], lanes_per_warp,
                        lib.qvz_decoder_smem_limit() - 1024, layout)


def card_layout(dplan_t: dict, lmax: int) -> int:
    """The layout K5 takes for lanes of at most lmax lines of this plan on
    the current card (``launch_shape``)."""
    return _card_shape(_build.load(), dplan_t, lmax, LANES_PER_WARP)["layout"]


def decode_lanes_t(dplan_t: dict, pays: LanePayloads, draws_t: torch.Tensor,
                   cl: torch.Tensor | None, lane_counts, base: int,
                   states: torch.Tensor, out: torch.Tensor,
                   sym_add: int = 0, cols_run: int | None = None,
                   lanes_per_warp: int = LANES_PER_WARP,
                   layout: int | None = None,
                   start_flags: torch.Tensor | None = None) -> torch.Tensor:
    """Decode the lanes into the rows of `out` (see the module docstring)
    and return their final states, (W, 5) int64 rows of (l, u, t,
    consumed bits, flags). draws_t: (cols, N) uint8; cl: (N,) uint8 or
    None with one cluster; states: (W, 4) int64 start (l, u, t, consumed
    bits); out: (N, cols or cols + 1) uint8. cols_run stops after that
    many columns. start_flags, (W,) int64 or None: K5p's flags; a lane
    with one decodes nothing (its rows are left as they are) and keeps it
    in its final flags. CPU tensors take the plain version; CUDA tensors launch
    K5 (csrc/decoder.cu), lanes_per_warp lanes in each warp, in `layout`
    (``launch_shape``'s choice where None), with each lane's records of
    the plan's models at risk (``coder_device.risk_tables``) in device
    memory where it has any, or raise."""
    _check(dplan_t, pays, draws_t, cl, lane_counts, base, states, out,
           cols_run, start_flags)
    dev = draws_t.device
    if dev.type == "cpu":
        return decode_lanes_reference(dplan_t, pays, draws_t, cl,
                                      lane_counts, base, states, out,
                                      sym_add, cols_run, start_flags)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    lib = _build.load()
    cols = dplan_t["columns"]
    cols_run = cols if cols_run is None else cols_run
    W = len(lane_counts)
    S = dplan_t["S"]
    n = draws_t.shape[1]
    draws_t = draws_t.contiguous()
    states = states.contiguous()
    flat = _packed_words(pays)
    lmax = int(max(lane_counts, default=0))
    shape = _card_shape(lib, dplan_t, lmax, lanes_per_warp, layout)
    scratch = _uses_scratch(shape, W, dev)
    # each lane's records of a column's models at risk, refilled a column
    risk = risk_tables(dplan_t, lmax)
    rmax = int(np.diff(risk["roff_h"][: cols_run + 1]).max(initial=0))
    rec = (torch.empty(W * rmax * 2, dtype=torch.int32, device=dev)
           if rmax else None)
    offs = _lane_offsets(lane_counts, base, dev)
    out_t = torch.empty((max(cols_run, 1), n), dtype=torch.uint8,
                        device=dev)
    state_out = torch.empty((W, 5), dtype=torch.int64, device=dev)
    hi = base + int(np.sum(lane_counts))
    _build.launch(
        "decoder", "lane decoder kernel", dev, lib.qvz_decode_lanes,
        flat.data_ptr(), pays.off.data_ptr(), pays.len.data_ptr(),
        draws_t.data_ptr(), n,
        cl.contiguous().data_ptr() if cl is not None else None,
        offs.data_ptr(), W, cols, cols_run,
        dplan_t["ptab"].data_ptr(), dplan_t["ptab"].shape[1],
        dplan_t["qrtab"].data_ptr(), dplan_t["mloc"].data_ptr(),
        dplan_t["mtab"].data_ptr(), dplan_t["col_model_off"].data_ptr(),
        dplan_t["init_counts"].data_ptr(), dplan_t["col_slots"].data_ptr(),
        dplan_t["symtab"].data_ptr(), S, states.data_ptr(),
        start_flags.contiguous().data_ptr() if start_flags is not None
        else None, out_t.data_ptr(),
        out.data_ptr(), out.shape[1], sym_add, state_out.data_ptr(),
        shape["layout"], *_risk_args(risk, rec), rmax,
        scratch.data_ptr() if scratch is not None else None,
        shape["lpw"], shape["lpb"], shape["lt"], shape["s_pad"],
        shape["m_pad"], shape["smem"], base, hi)
    return state_out


def decode_lanes(dplan: DecodePlan, payloads, draws, cl, states,
                 device="cuda"):
    """The contract of ``qvz_tpu.ops.decoder_device.decode_lanes``: W
    equal-length lanes, payloads a list of W byte strings, draws
    (cols, W, L) uint8, cl (W, L) uint8 cluster ids (zeros with one
    cluster), states W (l, u, t, consumed bits) start tuples. Returns (qv
    (W, L, cols) uint8 symbol values, flags (W,) bool), on `device`'s
    path: the plain version on the CPU, K5 on a CUDA device (the default;
    it raises where no card is visible)."""
    device = resolve(device)
    cols = dplan.columns
    W, L = cl.shape
    dt = torch.from_numpy(np.ascontiguousarray(
        np.asarray(draws, dtype=np.uint8).reshape(cols, W * L))).to(device)
    clt = torch.from_numpy(np.ascontiguousarray(
        cl, dtype=np.uint8).reshape(-1)).to(device)
    st = torch.as_tensor(np.asarray(states, dtype=np.int64).reshape(W, 4),
                         device=device)
    out = torch.zeros((W * L, cols), dtype=torch.uint8, device=device)
    final = decode_lanes_t(decode_plan_to_torch(dplan, device),
                           pack_payloads(payloads, device), dt, clt,
                           [L] * W, 0, st, out)
    return (out.reshape(W, L, cols).cpu().numpy(),
            final[:, 4].cpu().numpy() != 0)
