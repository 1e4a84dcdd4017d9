"""The QVZ2 encode, from the quality text to the container's bytes.

QVZ2 is the sharded form of QVZ's single-stream format: the reads split
into contiguous shards, each an arithmetic stream of its own whose WELL
dither draws continue the file's one stream (each shard starts where
the previous one ended, by jump-ahead). With priming, shard 0 is a
warmup shard and every other shard starts its adaptive models from the
counts the warmup shard's stream leaves. Within a shard, every read's
cluster id is coded first (model 0), then column 0 of every read, then
column 1, and so on (column-major order). The container:

    ">4sBBBBIQI"  b"QVZ2", version 4, clusters, order 1, priming,
                  columns, lines, shards
    the codebook blocks of every cluster (codebook.c:474-555)
    the file's 128-byte WELL state (shard 0's)
    per shard ">QQQ" lines, payload bytes, XXH64 of the payload, and
                  its 128-byte WELL start state
    the payloads, shard after shard

A quantizer pair p of a (cluster, column) context is chosen by the 7-bit
draw: the high one where draw >= trunc(128 * ratio); its model is
1 + 2p + choice and the coded symbol is the index of the quantized value
in the quantizer's reconstruction points (the last one, where a value
repeats). The context of a column is the previous column's quantized
value; column 0 has one.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import struct
import time
from dataclasses import dataclass

import numpy as np

from . import coder, design, kmeans, well
from .design import A

MAGIC = b"QVZ2"
VERSION = 4


@dataclass
class Config:
    """The settings of an encode, as a configuration file states them."""
    clusters: int
    ratio: float
    cluster_threshold: float
    shards: int                 # 0: the device lane count
    prime: bool
    warmup_lines: int           # the cap of the warmup shard


def lane_count(n: int) -> int:
    """The shard count of shards = 0: a lane per 256 reads, at least 16
    and a lane per 1,536 reads, at most 8,192."""
    return max(16, min(8192, max(n // 256, -(-n // 1536))))


def _split(n: int, shards: int) -> list:
    per = max(4, (-(-n // shards) + 3) & ~3)
    return [min(per, n - lo) for lo in range(0, n, per)]


def plan(n: int, cfg: Config) -> tuple:
    """Reads per shard, and whether shard 0 is a warmup shard. Shards
    hold a multiple of 4 reads but the last, so that every shard starts
    on a 32-bit WELL word (4 draws a word)."""
    shards = cfg.shards or lane_count(n)
    shards = max(1, min(shards, n))
    warm = min(cfg.warmup_lines, max(8192, n // 12)) if cfg.prime else 0
    if warm > 0 and shards > 1 and n > 2 * warm:
        w = max(4, (min(warm, n // 2) + 3) & ~3)
        counts = [w] + _split(n - w, shards)
        return counts, len(counts) > 1
    return _split(n, shards), False


@dataclass
class Tables:
    """The coding tables of a design, in the encoder's form."""
    pair_base: np.ndarray       # (K * cols,) first pair of a context
    ctx: np.ndarray             # (K * cols, A) previous value -> context
    qratio: np.ndarray          # (pairs,)
    qv: np.ndarray              # (2 * pairs, A) value -> quantized value
    qs: np.ndarray              # (2 * pairs, A) value -> coded symbol
    card: np.ndarray            # (models,) model 0: the cluster ids


def tables(books: list, columns: int) -> Tables:
    pair_base, ctx, qratio, qv, qs, card = [], [], [], [], [], [len(books)]
    pairs = 0
    for cluster in books:
        for col in range(columns):
            b = cluster[col]
            pair_base.append(pairs)
            m = np.full(A, -1, dtype=np.int64)
            for j, s in enumerate(b.contexts):
                m[s] = j                      # the last one wins
            ctx.append(m)
            for j in range(len(b.contexts)):
                qratio.append(b.qratio[j])
                for q in (b.lo[j], b.hi[j]):
                    index = np.full(A, -1, dtype=np.int64)
                    for i, s in enumerate(q.out):
                        index[s] = i
                    qmap = q.q.astype(np.int64)
                    qv.append(qmap)
                    qs.append(index[qmap])
                    card.append(len(q.out))
                pairs += 1
    return Tables(np.array(pair_base, dtype=np.int64), np.array(ctx),
                  np.array(qratio, dtype=np.int64), np.array(qv),
                  np.array(qs), np.array(card, dtype=np.int64))


def shard_states(jumper: well.Jumper, state: np.ndarray, counts: list,
                 columns: int, primed: bool) -> np.ndarray:
    """Each shard's WELL start state (S, 32)."""
    if primed:
        first = jumper.jump(state[None, :], counts[0] * columns // 4)[0]
        rest = jumper.grid_states(first, 0, counts[1] * columns // 4,
                                  len(counts) - 1)
        return np.vstack([state[None, :], rest])
    return jumper.grid_states(state, 0, counts[0] * columns // 4,
                              len(counts))


def shard_draws(jumper: well.Jumper, states: np.ndarray, counts: list,
                columns: int, primed: bool, shards) -> dict:
    """The 7-bit draws (lines, cols) of each shard in `shards`, in
    (read, column) order from its start state: the warmup shard's as one
    stream, the lanes' side by side in lock step."""
    out = {}
    lanes = sorted(s for s in shards if not (primed and s == 0))
    if primed and 0 in shards:
        w = counts[0]
        out[0] = well.stream_draws(jumper, states[0], w * columns) \
            .reshape(w, columns)
    if lanes:
        per = max(counts[s] for s in lanes)
        words = well.step_words(states[lanes], -(-per * columns // 4))
        d = well.draws_from_words(words)             # (per*cols, lanes)
        for i, s in enumerate(lanes):
            c = counts[s]
            out[s] = np.ascontiguousarray(d[:c * columns, i]) \
                .reshape(c, columns)
    return out


def quantize(data: np.ndarray, clusters: np.ndarray, dither: np.ndarray,
             tb: Tables, columns: int):
    """(models (cols, N) int64, symbols (cols, N) uint8, quantized values
    (N, cols) uint8), column after column."""
    n = data.shape[0]
    models = np.empty((columns, n), dtype=np.int32)
    syms = np.empty((columns, n), dtype=np.uint8)
    recon = np.empty((n, columns), dtype=np.uint8)
    prev = np.zeros(n, dtype=np.int64)
    cl = clusters.astype(np.int64) * columns
    for col in range(columns):
        cc = cl + col
        c = tb.ctx[cc, prev]
        if (c < 0).any():
            raise ValueError(f"column {col}: a previous value that no "
                             "context holds")
        p = tb.pair_base[cc] + c
        pc = 2 * p + (dither[:, col] >= tb.qratio[p])
        d = data[:, col]
        qv = tb.qv[pc, d]
        models[col] = 1 + pc
        syms[col] = tb.qs[pc, d]
        recon[:, col] = qv
        prev = qv
    return models, syms, recon


def _plan_draws(job):
    """The shard plan, each shard's WELL state, and the draws of the
    shards `shards` (None: every shard)."""
    n, columns, cfg, state, shards = job
    counts, primed = plan(n, cfg)
    jumper = well.Jumper()
    states = shard_states(jumper, state, counts, columns, primed)
    shards = range(len(counts)) if shards is None else shards
    return counts, primed, states, shard_draws(jumper, states, counts,
                                               columns, primed, shards)


def _design_one(job):
    counts0, cond, ratio, dtype = job
    return design.design(counts0, cond, ratio, dtype=dtype)[0]


@dataclass
class Derived:
    """What the reference works out of one input before any coding."""
    counts: list
    primed: bool
    states: np.ndarray
    dither: dict                # shard -> its draws (lines, cols)
    books: list
    tables: Tables
    clusters: np.ndarray


def derive(data: np.ndarray, cfg: Config, state: np.ndarray,
           dtype=np.float64, pool=None, log=None, shards=None) -> Derived:
    """Clusters, statistics, codebooks, shard plan and the draws of the
    shards `shards` (None: all) of (N, cols) symbols; `state` is the
    file's WELL state (32,) uint32. dtype is the design's precision.
    With a process pool, the draws and each cluster's design
    (independent of each other) run side by side."""
    log = log or (lambda *a: None)
    n, columns = data.shape
    t = time.perf_counter()
    if shards is not None:
        shards = sorted(shards)
    job = (n, columns, cfg, state, shards)
    drawn = pool.apply_async(_plan_draws, (job,)) if pool else None
    clusters = kmeans.cluster(data, cfg.clusters, cfg.cluster_threshold)
    counts0, cond = kmeans.statistics(data, clusters, cfg.clusters)
    log("clusters and statistics", time.perf_counter() - t)
    t = time.perf_counter()
    jobs = [(counts0[k:k + 1], cond[k:k + 1], cfg.ratio, dtype)
            for k in range(cfg.clusters)]
    books = (pool.map(_design_one, jobs) if pool and cfg.clusters > 1
             else [_design_one(j) for j in jobs])
    log("design", time.perf_counter() - t)
    t = time.perf_counter()
    counts, primed, states, dither = (drawn.get() if drawn
                                      else _plan_draws(job))
    log("waiting for the draws", time.perf_counter() - t)
    return Derived(counts, primed, states, dither, books,
                   tables(books, columns), clusters)


def _quantize_job(job):
    data, clusters, dither, tb = job
    return quantize(data, clusters, dither, tb, data.shape[1])[2]


def recon(data: np.ndarray, cfg: Config, state: np.ndarray,
          dtype=np.float64, workers: int = 0, log=None) -> np.ndarray:
    """The quantized values (N, cols) of (N, cols) symbols, quantized in
    blocks of reads side by side (a read's context chain is its own)."""
    log = log or (lambda *a: None)
    with _pool(workers) as pool:
        dv = derive(data, cfg, state, dtype, pool, log)
        t = time.perf_counter()
        cuts = np.linspace(0, len(data), max(1, workers) + 1).astype(int)
        dither = np.concatenate([dv.dither[i]
                                 for i in range(len(dv.counts))])
        jobs = [(data[a:b], dv.clusters[a:b], dither[a:b], dv.tables)
                for a, b in zip(cuts[:-1], cuts[1:])]
        out = np.concatenate(pool.map(_quantize_job, jobs) if pool
                             else [_quantize_job(j) for j in jobs])
        log("quantize", time.perf_counter() - t)
        return out


def _warmup_job(job) -> tuple:
    lo, hi, tot = job
    pay = coder.chain_one(lo, hi, tot)
    return pay, xxh64(pay)


def _lanes_job(job) -> list:
    """(payload, XXH64) of each lane of a block of lanes: its reads
    quantized, the triples of one segment (the cluster ids, then each
    column) of every lane at a time into a (step, lane) grid, then the
    lanes' interval chains side by side."""
    data, clusters, dither, tb, lines, bank_counts, bank_total = job
    columns = data.shape[1]
    models, syms, _ = quantize(data, clusters, dither, tb, columns)
    card = tb.card
    n = len(clusters)
    lane_n = len(lines)
    t_n = int(lines.max()) * (columns + 1)
    lane = np.repeat(np.arange(lane_n), lines)
    within = np.arange(n) - np.repeat(np.cumsum(lines) - lines, lines)
    grid = [np.zeros((t_n, lane_n), dtype=np.int32),
            np.ones((t_n, lane_n), dtype=np.int32),
            np.ones((t_n, lane_n), dtype=np.int32)]
    for seg in range(columns + 1):
        if seg == 0:
            model = np.zeros(n, dtype=np.int64)
            sym = clusters.astype(np.int64)
        else:
            model = models[seg - 1].astype(np.int64)
            sym = syms[seg - 1].astype(np.int64)
        trip = coder.triples(model, sym, lane, card,
                             lambda m: bank_counts[m],
                             lambda m: bank_total[m])
        pos = lines[lane] * seg + within
        for g, v in zip(grid, trip):
            g[pos, lane] = v
    pays = coder.chain(*grid, lines * (columns + 1))
    return [(p, xxh64(p)) for p in pays]


def payloads(data: np.ndarray, dv: Derived, shards, pool=None,
             blocks: int = 1, log=None) -> dict:
    """shard -> (payload bytes, XXH64) of each shard in `shards`. The
    warmup shard's counts after its stream (the primed bank) come first;
    then its serial chain and `blocks` blocks of the lanes asked for run
    side by side."""
    log = log or (lambda *a: None)
    t = time.perf_counter()
    tb = dv.tables
    card = tb.card
    w = int(card.max())
    fresh = np.where(np.arange(w)[None, :] < card[:, None], 1, 0)
    bank_counts, bank_total = fresh.copy(), card.copy()
    offs = np.concatenate([[0], np.cumsum(dv.counts)])
    columns = data.shape[1]
    warm = None
    first = 0
    if dv.primed:
        k = dv.counts[0]
        models, syms, _ = quantize(data[:k], dv.clusters[:k], dv.dither[0],
                                   tb, columns)
        parts = []
        for seg in range(columns + 1):
            model = (np.zeros(k, dtype=np.int64) if seg == 0
                     else models[seg - 1].astype(np.int64))
            sym = (dv.clusters[:k] if seg == 0 else syms[seg - 1])
            lo, hi, tot, _, g_model, g_counts, g_total = coder.triples(
                model, sym.astype(np.int64), np.zeros(k, dtype=np.int64),
                card, lambda m: fresh[m], lambda m: card[m],
                want_final=True)
            bank_counts[g_model, :g_counts.shape[1]] = g_counts
            bank_total[g_model] = g_total
            parts.append((lo, hi, tot))
        if 0 in shards:
            job = tuple(np.concatenate(v) for v in zip(*parts))
            warm = (pool.apply_async(_warmup_job, (job,)) if pool
                    else _warmup_job(job))
        first = 1
    log("the warmup shard's bank", time.perf_counter() - t)
    t = time.perf_counter()
    lanes = [s for s in sorted(shards) if s >= first]
    cuts = np.linspace(0, len(lanes), blocks + 1).astype(int)
    jobs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        ids = lanes[a:b]
        if not ids:
            continue
        rows = np.concatenate([np.arange(offs[s], offs[s + 1]) for s in ids])
        jobs.append((data[rows], dv.clusters[rows],
                     np.concatenate([dv.dither[s] for s in ids]), tb,
                     np.array([dv.counts[s] for s in ids], dtype=np.int64),
                     bank_counts, bank_total))
    done = (pool.map(_lanes_job, jobs) if pool
            else [_lanes_job(j) for j in jobs])
    log("lanes", time.perf_counter() - t)
    t = time.perf_counter()
    out = dict(zip(lanes, [p for block in done for p in block]))
    if warm is not None:
        out[0] = warm.get() if pool else warm
    log("waiting for the warmup shard's chain", time.perf_counter() - t)
    return out


_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, v: int) -> int:
    return (_rotl((acc + v * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes) -> int:
    """XXH64 with seed 0 (the public specification)."""
    n = len(data)
    p = 0
    if n >= 32:
        v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        lanes = np.frombuffer(data, dtype="<u8", count=(n // 32) * 4) \
            .reshape(-1, 4).tolist()
        for a, b, c, d in lanes:
            v = [_round(v[0], a), _round(v[1], b), _round(v[2], c),
                 _round(v[3], d)]
        p = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


def head(dv: Derived, columns: int) -> bytes:
    """The container up to its directory: the header, the codebooks and
    the file's WELL state."""
    return struct.pack(">4sBBBBIQI", MAGIC, VERSION, len(dv.books), 1,
                       1 if dv.primed else 0, columns, int(sum(dv.counts)),
                       len(dv.counts)) \
        + design.serialize(dv.books) + _state_bytes(dv.states[0])


def _state_bytes(state) -> bytes:
    return np.asarray(state, dtype="<u4").tobytes()


def container(dv: Derived, pays: dict, columns: int) -> bytes:
    out = bytearray(head(dv, columns))
    for s, (lines, st) in enumerate(zip(dv.counts, dv.states)):
        pay, h = pays[s]
        out += struct.pack(">QQQ", lines, len(pay), h) + _state_bytes(st)
    for s in range(len(dv.counts)):
        out += pays[s][0]
    return bytes(out)


def encode(data: np.ndarray, cfg: Config, state: np.ndarray,
           dtype=np.float64, workers: int = 0, log=None) -> bytes:
    """The container of (N, cols) symbols; workers > 0 runs the parts
    that are independent of each other in that many processes."""
    with _pool(workers) as pool:
        dv = derive(data, cfg, state, dtype, pool, log)
        pays = payloads(data, dv, range(len(dv.counts)), pool,
                        max(1, workers - 1), log)
    return container(dv, pays, data.shape[1])


@dataclass
class View:
    """What a container says, as the check reads it: the head (header,
    codebooks, the file's WELL state), every shard's directory entry up
    to its payload (lines, start state), and the payloads it holds
    (shard -> (payload bytes, the directory's XXH64))."""
    head: bytes
    entries: list               # per shard: ">Q" lines + 128-byte state
    pays: dict


def check_view(data: np.ndarray, cfg: Config, state: np.ndarray,
               shards, dtype=np.float64, workers: int = 0,
               log=None) -> View:
    """The reference's View of the container of (N, cols) symbols with
    the payloads of the shards `shards` only (the rest of the payloads
    are not worked out): every other byte of the container but the
    other shards' lengths and checksums."""
    with _pool(workers) as pool:
        dv = derive(data, cfg, state, dtype, pool, log, shards=shards)
        pays = payloads(data, dv, shards, pool, max(1, workers - 1), log)
    return View(head(dv, data.shape[1]),
                [struct.pack(">Q", c) + _state_bytes(st)
                 for c, st in zip(dv.counts, dv.states)], pays)


def read_view(blob: bytes, head_len: int) -> View:
    """The View of a container whose head is head_len bytes long (the
    reference's), from its header's shard count and its directory."""
    shards = struct.unpack_from(">I", blob, 20)[0] if len(blob) >= 24 else 0
    entries, lens = [], []
    at = head_len
    for _ in range(shards):
        if at + 152 > len(blob):
            break
        lines, n, h = struct.unpack_from(">QQQ", blob, at)
        entries.append((blob[at:at + 8] + blob[at + 24:at + 152], n, h))
        at += 152
    pays = {}
    for s, (_, n, h) in enumerate(entries):
        pays[s] = (blob[at:at + n], h)
        at += n
    return View(blob[:head_len], [e for e, _, _ in entries], pays)


def _off(a: bytes, b: bytes) -> int:
    m = min(len(a), len(b))
    return int((np.frombuffer(a[:m], np.uint8)
                != np.frombuffer(b[:m], np.uint8)).sum()) \
        + abs(len(a) - len(b))


def bytes_off(got: View, want: View) -> int:
    """The bytes of the reference's View that `got` does not hold alike:
    the head, every directory entry's lines and state, and each payload
    the reference worked out with its length and checksum (a missing
    part counts all its bytes)."""
    off = _off(got.head, want.head)
    for s, e in enumerate(want.entries):
        off += _off(got.entries[s], e) if s < len(got.entries) else len(e)
    off += 152 * max(0, len(got.entries) - len(want.entries))
    for s, (pay, h) in want.pays.items():
        if s not in got.pays:
            off += len(pay) + 16
            continue
        gpay, gh = got.pays[s]
        off += _off(gpay, pay) + 8 * (gh != h) + 8 * (len(gpay) != len(pay))
    return off


@contextlib.contextmanager
def _pool(workers: int):
    if workers <= 0:
        yield None
        return
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        yield pool


def parse_text(text: bytes) -> np.ndarray:
    """Quality text (lines of equal length, newline-ended) -> (N, cols)
    symbols, Phred+33 removed."""
    raw = np.frombuffer(text, dtype=np.uint8)
    cols = int(np.argmax(raw == 10))
    rows = raw[:len(raw) // (cols + 1) * (cols + 1)].reshape(-1, cols + 1)
    if not (rows[:, cols] == 10).all():
        raise ValueError("lines of unequal length")
    return rows[:, :cols] - 33


def to_text(symbols: np.ndarray) -> np.ndarray:
    """(N, cols) symbols -> (N, cols + 1) Phred+33 text with newlines."""
    n, cols = symbols.shape
    out = np.empty((n, cols + 1), dtype=np.uint8)
    out[:, :cols] = symbols + 33
    out[:, cols] = 10
    return out
