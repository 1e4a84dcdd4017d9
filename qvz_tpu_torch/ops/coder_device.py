"""Lane-parallel adaptive arithmetic encoder on the device.

The QVZ2 container's shards are independent adaptive arithmetic streams
(column-major symbol order, a shared primed model bank). Each shard after
the warmup shard is one lane; lanes are coded in parallel and produce
payload bytes identical to the host coder (qvz_rt.cpp Encoder/ModelBank;
reference src/arith.c:24-96, src/qv_stream.c:9-61). Counterpart of
``qvz_tpu.ops.coder_device``; the CUDA kernel K2 (``csrc/coder.cu``)
replaces ``qvz_tpu.ops.coder_pallas._kernel3``.

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
        for c in range(cols):
            parts = [counts_init[offs[m]: offs[m] + cards[m]]
                     for m in col_models[c]]
            v = np.concatenate(parts) if parts else \
                np.zeros(0, dtype=np.uint32)
            init_counts_cols[c, : len(v)] = v

        self.S = S
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
        "slot_base": t(plan.slot_base),
        "cards": t(plan.cards),
        "init_counts": t(plan.init_counts_cols),
        "col_slots": t(plan.col_slots),
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


def encode_lanes_reference(plan_t: dict, mid: torch.Tensor,
                           qs: torch.Tensor, lane_counts, base: int,
                           cluster_triples: np.ndarray | None = None):
    """Plain PyTorch version of K2: the per-step loop vectorised over
    lanes, in int64, the cluster-id segment first when cluster_triples
    is given. Returns the raw lane output (words, n_words, carry)
    described in the module docstring."""
    dev = mid.device
    cols = mid.shape[0]
    W = len(lane_counts)
    L = int(max(lane_counts)) if W else 0
    S = plan_t["S"]
    A = 72  # no model has more symbols than the alphabet

    offs = _lane_offsets(lane_counts, base, dev)
    j = torch.arange(L, device=dev)
    valid = j[None, :] < (offs[1:] - offs[:-1])[:, None]          # (W, L)
    idx = torch.where(valid, offs[:-1, None] + j[None, :], 0)
    slot_base = plan_t["slot_base"].long()
    cards = plan_t["cards"].long()
    init_counts = plan_t["init_counts"].long()
    ar = torch.arange(A, device=dev)
    ar_w = torch.arange(W, device=dev)

    zero = torch.zeros(W, dtype=torch.long, device=dev)
    l, u, s3, acc, nacc = zero, zero + FULL, zero, zero, zero
    flag = torch.zeros(W, dtype=torch.bool, device=dev)
    words, flushes = [], []

    def code(clo, chi, n):
        nonlocal l, u, s3, acc, nacc, flag
        (l, u, s3, acc, nacc, flag), (w0, f0, w1, f1) = _coder_step(
            l, u, s3, acc, nacc, flag, clo, chi, n)
        words.extend((w0, w1))
        flushes.extend((f0, f1))

    if cluster_triples is not None:
        ct = torch.as_tensor(cluster_triples.astype(np.int64), device=dev)
        for t in range(L):
            # pad steps past a ragged lane's end take the no-op (0, 1, 1)
            v = valid[:, t]
            code(torch.where(v, ct[:, t, 0], 0),
                 torch.where(v, ct[:, t, 1], 1),
                 torch.where(v, ct[:, t, 2], 1))
    for c in range(cols):
        m = torch.where(valid, mid[c][idx].long(), 0)              # (W, L)
        x = torch.where(valid, qs[c][idx].long(), 0)
        sb = slot_base[m]
        card = cards[m]
        live = (m > 0) & (card > 1)
        counts = init_counts[c].expand(W, S).clone()
        for t in range(L):
            sbt, xt, lv = sb[:, t], x[:, t], live[:, t]
            g = counts.gather(1, (sbt[:, None] + ar).clamp(max=S - 1))
            total = (g * (ar < card[:, t, None])).sum(1)
            cum_lo = (g * (ar < xt[:, None])).sum(1)
            cx = g[ar_w, xt]
            flag = flag | (lv & (total + STEP > ARITH_R))
            counts[ar_w, (sbt + xt).clamp(max=S - 1)] += STEP * lv
            # no-op steps take the triple (0, 1, 1)
            code(torch.where(lv, cum_lo, 0), torch.where(lv, cum_lo + cx, 1),
                 torch.where(lv, total, 1))

    carry = torch.stack([l, u, s3, acc, nacc, flag.long()])
    if not words:
        return (torch.zeros((W, 0), dtype=torch.int32, device=dev),
                torch.zeros(W, dtype=torch.int32, device=dev), carry)
    wt = torch.stack(words, 1)                                    # (W, 2T)
    ft = torch.stack(flushes, 1)
    n_words = ft.sum(1)
    dst = ft.long().cumsum(1) - 1
    out = torch.zeros((W, int(n_words.max())), dtype=torch.long,
                      device=dev)
    lane = ar_w[:, None].expand_as(dst)
    out[lane[ft], dst[ft]] = wt[ft]
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(torch.int32), n_words.to(torch.int32), carry


def _check(plan_t, mid, qs, lane_counts, base, cluster_triples):
    if cluster_triples is not None:
        want = (len(lane_counts), int(max(lane_counts)), 3)
        if cluster_triples.dtype != np.uint32 \
                or cluster_triples.shape != want:
            raise ValueError(f"cluster_triples must be {want} uint32")
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


def code_lanes(plan_t: dict, mid: torch.Tensor, qs: torch.Tensor,
               lane_counts, base: int,
               cluster_triples: np.ndarray | None = None):
    """Code lane w = lines base + sum(lane_counts[:w]) onwards, for
    lane_counts[w] lines, from the (cols, N) int32 quantize outputs;
    cluster_triples, (W, max lane count, 3) uint32 or None, are the
    lanes' cluster-id steps. Returns the raw lane output (words, n_words,
    carry). CPU tensors take the plain version; CUDA tensors launch K2
    (csrc/coder.cu) or raise."""
    _check(plan_t, mid, qs, lane_counts, base, cluster_triples)
    if mid.device.type == "cpu":
        return encode_lanes_reference(plan_t, mid, qs, lane_counts, base,
                                      cluster_triples)
    if mid.device.type != "cuda":
        raise ValueError(f"unsupported device {mid.device}")
    lib = _build.load()
    dev = mid.device
    mid = mid.contiguous()
    qs = qs.contiguous()
    cols, n = mid.shape
    W = len(lane_counts)
    S = plan_t["S"]
    offs = _lane_offsets(lane_counts, base, dev)
    L = int(max(lane_counts)) if W else 0
    ct = None
    if cluster_triples is not None:
        ct = torch.from_numpy(np.ascontiguousarray(
            cluster_triples).view(np.int32)).to(dev)
    max_steps = (cols + (ct is not None)) * L
    max_words = -(-max_steps * BITS_PER_STEP_BOUND // 32) + 2
    counts = torch.empty((W, S), dtype=torch.int32, device=dev)
    words = torch.empty((W, max_words), dtype=torch.int32, device=dev)
    n_words = torch.empty(W, dtype=torch.int32, device=dev)
    carry = torch.empty((6, W), dtype=torch.int64, device=dev)
    rc = lib.qvz_code_lanes(
        mid.data_ptr(), qs.data_ptr(), n, cols, offs.data_ptr(), W,
        ct.data_ptr() if ct is not None else None, L,
        plan_t["slot_base"].data_ptr(), plan_t["cards"].data_ptr(),
        plan_t["init_counts"].data_ptr(), plan_t["col_slots"].data_ptr(),
        S, counts.data_ptr(), words.data_ptr(), max_words,
        n_words.data_ptr(), carry.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lane coder kernel")
    _build.LAUNCHES["coder"] += 1
    return words, n_words, carry


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
                     timings: dict | None = None):
    """(payloads, flags) for the lanes of the (cols, N) quantize outputs:
    the contract of ``qvz_tpu.ops.coder_device.encode_lanes_raw``. Lane w
    covers lines base + sum(lane_counts[:w]) onwards; cluster_triples
    (W, max lane count, 3) uint32 are its cluster-id steps, None with one
    cluster. payloads[w] is None where flags[w] is set and the caller
    must re-code that lane on the host. timings, if given, gets the
    seconds of the device-to-host copy under "d2h" (fenced)."""
    raw = code_lanes(plan_t, mid, qs, lane_counts, base, cluster_triples)
    if mid.device.type == "cuda":
        torch.cuda.synchronize(mid.device)
    t0 = time.perf_counter()
    fetched = fetch_lanes(*raw)
    if timings is not None:
        timings["d2h"] = time.perf_counter() - t0
    return payloads_from_raw(*fetched)
