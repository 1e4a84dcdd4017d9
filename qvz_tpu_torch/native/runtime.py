"""Numpy-facing wrapper over the port's native runtime library (a copy
of ``qvz_tpu.native.runtime`` with the entry points the port calls)."""

from __future__ import annotations

import ctypes

import numpy as np

from qvz_tpu_torch import native
from qvz_tpu_torch.constants import (ALPHABET_SIZE,
                                     MAX_KMEANS_ITERATIONS)
from qvz_tpu_torch.spec import kmeans as spec_kmeans

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_dp = ctypes.POINTER(ctypes.c_double)


def _ptr(arr: np.ndarray, ptype):
    return arr.ctypes.data_as(ptype)


def well_draws7(state_words, n_draws: int) -> np.ndarray:
    """All 7-bit dither draws from a WELL-1024a state (n=0, empty pool)."""
    lib = native.load()
    st = np.ascontiguousarray(state_words, dtype=np.uint32)
    out = np.empty(n_draws, dtype=np.uint8)
    lib.qvz_well_draws7(_ptr(st, _u32p), n_draws, _ptr(out, _u8p))
    return out


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of a byte string (QVZ2 per-shard payload checksums)."""
    lib = native.load()
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(lib.qvz_xxh64(_ptr(buf, _u8p), len(data), seed))


def replay_model(init_counts: np.ndarray, init_total: int,
                 syms: np.ndarray) -> np.ndarray:
    """Exact per-occurrence (cum_lo, cum_hi, total) triples for ONE
    adaptive model, with full update semantics incl. rescale
    (qv_stream.c:9-25). The host oracle of K2s, the device coder's
    cluster-id segment."""
    lib = native.load()
    ic = np.ascontiguousarray(init_counts, dtype=np.uint32)
    s = np.ascontiguousarray(syms, dtype=np.uint8)
    out = np.empty((len(s), 3), dtype=np.uint32)
    lib.qvz_replay_model(_ptr(ic, _u32p), len(ic), int(init_total),
                         _ptr(s, _u8p), len(s), _ptr(out, _u32p))
    return out


def well_jump(state_words, n_chunks: int, words_per_chunk: int
              ) -> np.ndarray:
    """GF(2) jump-ahead start states (n=0 semantics) for n_chunks
    contiguous word-chunks of one WELL stream; chunk 0 == input."""
    lib = native.load()
    st = np.ascontiguousarray(state_words, dtype=np.uint32)
    out = np.empty((n_chunks, 32), dtype=np.uint32)
    lib.qvz_well_jump(_ptr(st, _u32p), n_chunks, words_per_chunk,
                      _ptr(out, _u32p))
    return out


def well_pow_table() -> np.ndarray:
    """The GF(2) jump table of one WELL-1024a word step M: M^(2^k) for k
    = 0..63 as (64, 1024, 16) uint64, row i of M^(2^k) the 1,024 bits
    (16 words, least significant first) whose parity with the state
    vector (n=0 semantics: word w's bit b is vector bit 32 w + b) gives
    bit i of the state 2^k words on."""
    out = np.empty((64, 1024, 16), dtype=np.uint64)
    native.load().qvz_well_pow_table(_ptr(out, _u64p))
    return out


class Tables:
    """Flat coding tables (see qvz_rt.cpp Tables). Owns the C++ handle."""

    def __init__(self, handle, lib, columns: int, n_clusters: int):
        self._h = handle
        self._lib = lib
        self.columns = columns
        self.n_clusters = n_clusters
        self.n_pairs = lib.qvz_tables_n_pairs(handle)
        self.n_models = lib.qvz_tables_n_models(handle)
        self.consumed = lib.qvz_tables_consumed(handle)
        n_cols_total = n_clusters * columns

        def view(fn, dtype, shape):
            # Zero-copy views into C++-owned storage; kept alive by self._h.
            ptr = fn(handle)
            size = int(np.prod(shape))
            return np.ctypeslib.as_array(ptr, shape=(size,)).reshape(shape)

        self.pair_base = view(lib.qvz_tables_pair_base, np.uint32,
                              (n_cols_total,))
        self.ctxmap = view(lib.qvz_tables_ctxmap, np.int32,
                           (n_cols_total, ALPHABET_SIZE))
        self.qratio = view(lib.qvz_tables_qratio, np.uint8, (self.n_pairs,))
        self.model_card = view(lib.qvz_tables_model_card, np.uint32,
                               (self.n_models,))
        self.model_off = view(lib.qvz_tables_model_off, np.uint64,
                              (self.n_models + 1,))
        syms_len = lib.qvz_tables_model_syms_len(handle)
        self.model_syms = view(lib.qvz_tables_model_syms, np.uint8,
                               (syms_len,))
        self.qv_map = view(lib.qvz_tables_qv_map, np.uint8,
                           (self.n_pairs * 2, ALPHABET_SIZE))
        self.qs_map = view(lib.qvz_tables_qs_map, np.uint8,
                           (self.n_pairs * 2, ALPHABET_SIZE))
        # the device quantizer's folded forms: ctx2 = the context (0 for
        # an unreachable prev) | the pair's qratio << 8; qsv = qs | qv << 8
        self.ctx2 = view(lib.qvz_tables_ctx2, np.uint32,
                         (n_cols_total, ALPHABET_SIZE))
        self.qsv = view(lib.qvz_tables_qsv, np.uint16,
                        (self.n_pairs * 2, ALPHABET_SIZE))
        self.bank_words = int(lib.qvz_tables_bank_words(handle))

    def __del__(self):
        try:
            self._lib.qvz_tables_free(self._h)
        except Exception:
            pass


class Design:
    """Designed codebooks for all clusters. Owns the C++ handle."""

    def __init__(self, counts0: np.ndarray, cond_counts: np.ndarray,
                 mode: int, ratio: float, dist: np.ndarray):
        lib = native.load()
        self._lib = lib
        n_clusters, a = counts0.shape
        assert a == ALPHABET_SIZE
        columns = cond_counts.shape[1] + 1
        c0 = np.ascontiguousarray(counts0, dtype=np.uint64)
        cc = np.ascontiguousarray(cond_counts, dtype=np.uint64)
        d = np.ascontiguousarray(dist, dtype=np.float64)
        self._h = lib.qvz_design_create(
            _ptr(c0, _u64p), _ptr(cc, _u64p), n_clusters, columns,
            mode, ratio, _ptr(d, _dp))
        self.columns = columns
        self.n_clusters = n_clusters

    def serialized(self) -> bytes:
        n = self._lib.qvz_design_serialized_size(self._h)
        out = np.empty(n, dtype=np.uint8)
        self._lib.qvz_design_serialized(self._h, _ptr(out, _u8p))
        return out.tobytes()

    def stats(self) -> dict:
        """What the design did: ``serial_s``, its steady-clock seconds
        outside the context sweeps, summed over the clusters (with the
        clusters designed on threads at once, the sum can pass the wall
        time); ``lloyd_iters``, the Lloyd-Max iterations of every
        quantizer it designed; ``lloyd_discarded_iters``, those of the
        speculative candidates it threw away unread. The counts are the
        same for the same input on the same number of cores."""
        out = np.zeros(3, dtype=np.int64)
        self._lib.qvz_design_stats(self._h, _ptr(out, _i64p))
        return dict(serial_s=int(out[0]) / 1e9, lloyd_iters=int(out[1]),
                    lloyd_discarded_iters=int(out[2]))

    def tables(self) -> Tables:
        h = self._lib.qvz_tables_from_design(self._h)
        return Tables(h, self._lib, self.columns, self.n_clusters)

    def __del__(self):
        try:
            self._lib.qvz_design_free(self._h)
        except Exception:
            pass


def tables_from_blocks(blocks: bytes, n_clusters: int,
                       columns: int) -> Tables:
    lib = native.load()
    buf = np.frombuffer(blocks, dtype=np.uint8)
    h = lib.qvz_tables_from_blocks(_ptr(buf, _u8p), len(blocks),
                                   n_clusters, columns)
    if not h:
        raise ValueError("malformed codebook blocks")
    return Tables(h, lib, columns, n_clusters)


def kmeans_host(data: np.ndarray, n_clusters: int, threshold: float,
                verbose: bool = False):
    """Reference-exact k-means on host threads; API-compatible with
    ops.kmeans.kmeans_cluster (integer distances/means, first-min,
    max-squared-movement stop vs threshold, cluster.c:212-243)."""
    n = data.shape[0]
    if n_clusters == 1:
        return np.zeros(n, dtype=np.uint8), data[:1].copy(), 0
    data = np.ascontiguousarray(data, dtype=np.uint8)
    means = spec_kmeans.seed_centroids(data, n_clusters,
                                       verbose=verbose).astype(np.int64)
    iters = 0
    while iters < MAX_KMEANS_ITERATIONS:
        assign, sums, counts = kmeans_iter(data, means)
        iters += 1
        means, stop = spec_kmeans.update_means(means, sums, counts,
                                               threshold, verbose)
        if stop:
            break
    if verbose:
        spec_kmeans.verbose_total(iters)
    return assign, means.astype(np.uint8), iters


def kmeans_iter(data: np.ndarray, means: np.ndarray):
    """One threaded Lloyd iteration over a (local) row range: returns
    (assign u8, sums i64 (k, cols), counts i64 (k,)). The caller owns
    the convergence loop and the integer merge across chunks or hosts:
    partial sums are exact integers, so any merge order is bit-identical
    (cluster.c:80-171 semantics)."""
    lib = native.load()
    n, cols = data.shape
    k = means.shape[0]
    data = np.ascontiguousarray(data, dtype=np.uint8)
    means = np.ascontiguousarray(means, dtype=np.int64)
    assign = np.empty(n, dtype=np.uint8)
    sums = np.empty((k, cols), dtype=np.int64)
    counts = np.empty(k, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.qvz_kmeans_iter(_ptr(data, _u8p), n, cols, _ptr(means, i64p), k,
                        _ptr(assign, _u8p), _ptr(sums, i64p),
                        _ptr(counts, i64p))
    return assign, sums, counts


def stats_host(data: np.ndarray, clusters: np.ndarray | None,
               n_clusters: int, accumulate=None):
    """Single-pass C++ conditional histogram (codebook.c:185-203):
    (counts0 (C, 72), cond (C, cols-1, 72, 72)) int64, as
    ops.stats.conditional_counts gives them. accumulate: optional
    (counts0 u64, cond u64) arrays to add into (chunked statistics); the
    returned dtype then stays uint64."""
    lib = native.load()
    n, cols = data.shape
    data = np.ascontiguousarray(data, dtype=np.uint8)
    cl = (np.ascontiguousarray(clusters, dtype=np.uint8)
          if clusters is not None else None)
    if accumulate is not None:
        counts0, cond = accumulate
        assert counts0.dtype == np.uint64 and cond.dtype == np.uint64
        assert counts0.flags["C_CONTIGUOUS"] and cond.flags["C_CONTIGUOUS"]
    else:
        counts0 = np.zeros((n_clusters, ALPHABET_SIZE), dtype=np.uint64)
        cond = np.zeros((n_clusters, cols - 1, ALPHABET_SIZE,
                         ALPHABET_SIZE), dtype=np.uint64)
    lib.qvz_stats(_ptr(data, _u8p), n, cols,
                  _ptr(cl, _u8p) if cl is not None else None,
                  _ptr(counts0, _u64p), _ptr(cond, _u64p))
    if accumulate is not None:
        return counts0, cond
    return counts0.astype(np.int64), cond.astype(np.int64)


def encode_lines(tables: Tables, cluster_ids, model_ids: np.ndarray,
                 syms: np.ndarray) -> bytes:
    """Arithmetic-code the full stream in reference order."""
    lib = native.load()
    n, cols = model_ids.shape
    model_ids = np.ascontiguousarray(model_ids, dtype=np.uint32)
    syms = np.ascontiguousarray(syms, dtype=np.uint8)
    cl = (np.ascontiguousarray(cluster_ids, dtype=np.uint8)
          if cluster_ids is not None else None)
    cards = np.ascontiguousarray(tables.model_card, dtype=np.uint32)
    cap = n * cols + (n * cols) // 2 + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        r = lib.qvz_encode_lines(
            _ptr(cl, _u8p) if cl is not None else None,
            _ptr(model_ids, _u32p), _ptr(syms, _u8p), n, cols,
            _ptr(cards, _u32p), tables.n_models, _ptr(out, _u8p), cap)
        if r >= 0:
            return out[:r].tobytes()
        cap = -r + 4096


def encode_fused(tables: Tables, data: np.ndarray, cluster_ids,
                 well_state_words, dist: np.ndarray | None = None,
                 want_recon: bool = False, verbose: bool = False):
    """Fused quantize + arithmetic encode (inline WELL draws).

    Returns (payload bytes, recon or None, distortion_sum). The
    distortion_sum is sum over lines of per-line mean column distortion
    (divide by n_lines for the reference's -v/-s figure); 0.0 when dist
    is None.
    """
    lib = native.load()
    n, cols = data.shape
    data = np.ascontiguousarray(data, dtype=np.uint8)
    cl = (np.ascontiguousarray(cluster_ids, dtype=np.uint8)
          if cluster_ids is not None else None)
    st = np.ascontiguousarray(well_state_words, dtype=np.uint32)
    d = (np.ascontiguousarray(dist, dtype=np.float64)
         if dist is not None else None)
    recon = np.empty((n, cols), dtype=np.uint8) if want_recon else None
    dsum = ctypes.c_double(0.0)
    cap = n * cols + (n * cols) // 2 + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        r = lib.qvz_encode_fused(
            tables._h, _ptr(data, _u8p), n,
            _ptr(cl, _u8p) if cl is not None else None,
            _ptr(st, _u32p),
            _ptr(d, _dp) if d is not None else None,
            _ptr(recon, _u8p) if recon is not None else None,
            ctypes.byref(dsum), _ptr(out, _u8p), cap, int(verbose))
        if r >= 0:
            return out[:r].tobytes(), recon, dsum.value
        cap = -r + 4096


def encode_fused_colmajor(tables: Tables, data_t: np.ndarray, cluster_ids,
                          well_state_words, dist: np.ndarray | None = None,
                          want_recon: bool = False,
                          init_bank: np.ndarray | None = None,
                          want_bank: bool = False):
    """Column-major fused encode (QVZ2 shard payloads).

    data_t: (cols, n) uint8 column-major symbols. Identical quantization
    decisions (and reconstruction) to encode_fused; only the entropy-
    coding order differs, keeping each column's adaptive models
    L1-resident. Returns (payload, recon (n, cols) or None, dist_sum)
    plus the final model-bank snapshot when want_bank (shard priming).
    init_bank: snapshot to start the adaptive models from.
    """
    lib = native.load()
    cols, n = data_t.shape
    data_t = np.ascontiguousarray(data_t, dtype=np.uint8)
    cl = (np.ascontiguousarray(cluster_ids, dtype=np.uint8)
          if cluster_ids is not None else None)
    st = np.ascontiguousarray(well_state_words, dtype=np.uint32)
    d = (np.ascontiguousarray(dist, dtype=np.float64)
         if dist is not None else None)
    recon_t = np.empty((cols, n), dtype=np.uint8) if want_recon else None
    dsum = ctypes.c_double(0.0)
    ib = (np.ascontiguousarray(init_bank, dtype=np.uint32)
          if init_bank is not None else None)
    ob = (np.empty(tables.bank_words, dtype=np.uint32)
          if want_bank else None)
    cap = n * cols + (n * cols) // 2 + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        r = lib.qvz_encode_fused_colmajor(
            tables._h, _ptr(data_t, _u8p), n,
            _ptr(cl, _u8p) if cl is not None else None,
            _ptr(st, _u32p),
            _ptr(d, _dp) if d is not None else None,
            _ptr(recon_t, _u8p) if recon_t is not None else None,
            ctypes.byref(dsum), _ptr(out, _u8p), cap,
            _ptr(ib, _u32p) if ib is not None else None,
            _ptr(ob, _u32p) if ob is not None else None)
        if r >= 0:
            recon = recon_t.T.copy() if recon_t is not None else None
            if want_bank:
                return out[:r].tobytes(), recon, dsum.value, ob
            return out[:r].tobytes(), recon, dsum.value
        cap = -r + 4096


def quantize_colmajor(tables: Tables, data_t: np.ndarray, cluster_ids,
                      well_state_words, dist: np.ndarray | None = None,
                      want_recon: bool = False):
    """Column-major quantization only (no coder state): returns
    (model_t u32 (cols,n), qs_t u8 (cols,n), recon (n,cols) or None,
    dist_sum). Same decisions as encode_fused_colmajor; feed the
    outputs to encode_precomputed_colmajor."""
    lib = native.load()
    cols, n = data_t.shape
    data_t = np.ascontiguousarray(data_t, dtype=np.uint8)
    cl = (np.ascontiguousarray(cluster_ids, dtype=np.uint8)
          if cluster_ids is not None else None)
    st = np.ascontiguousarray(well_state_words, dtype=np.uint32)
    d = (np.ascontiguousarray(dist, dtype=np.float64)
         if dist is not None else None)
    recon_t = np.empty((cols, n), dtype=np.uint8) if want_recon else None
    model_t = np.empty((cols, n), dtype=np.uint32)
    qs_t = np.empty((cols, n), dtype=np.uint8)
    dsum = ctypes.c_double(0.0)
    lib.qvz_quantize_colmajor(
        tables._h, _ptr(data_t, _u8p), n,
        _ptr(cl, _u8p) if cl is not None else None,
        _ptr(st, _u32p),
        _ptr(d, _dp) if d is not None else None,
        _ptr(recon_t, _u8p) if recon_t is not None else None,
        ctypes.byref(dsum), _ptr(model_t, _u32p), _ptr(qs_t, _u8p))
    recon = recon_t.T.copy() if recon_t is not None else None
    return model_t, qs_t, recon, dsum.value


def encode_precomputed_colmajor(tables: Tables, model_t: np.ndarray,
                                qs_t: np.ndarray, cluster_ids,
                                n_lines: int,
                                init_bank: np.ndarray | None = None,
                                want_bank: bool = False):
    """Entropy-code a shard from device-precomputed (model id, symbol)
    streams in column-major order. Byte-identical to
    encode_fused_colmajor for the same quantization decisions.
    init_bank/want_bank: model-bank snapshot in/out (shard priming);
    with want_bank returns (payload, bank)."""
    lib = native.load()
    model_t = np.ascontiguousarray(model_t, dtype=np.uint32)
    qs_t = np.ascontiguousarray(qs_t, dtype=np.uint8)
    cl = (np.ascontiguousarray(cluster_ids, dtype=np.uint8)
          if cluster_ids is not None else None)
    ib = (np.ascontiguousarray(init_bank, dtype=np.uint32)
          if init_bank is not None else None)
    ob = (np.empty(tables.bank_words, dtype=np.uint32)
          if want_bank else None)
    cols = tables.columns
    cap = n_lines * cols + (n_lines * cols) // 2 + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        r = lib.qvz_encode_precomputed_colmajor(
            tables._h, _ptr(model_t, _u32p), _ptr(qs_t, _u8p),
            _ptr(cl, _u8p) if cl is not None else None,
            n_lines, _ptr(out, _u8p), cap,
            _ptr(ib, _u32p) if ib is not None else None,
            _ptr(ob, _u32p) if ob is not None else None)
        if r >= 0:
            return (out[:r].tobytes(), ob) if want_bank \
                else out[:r].tobytes()
        cap = -r + 4096


def bank_from_stream(tables: Tables, model_t: np.ndarray,
                     qs_t: np.ndarray, cluster_ids,
                     n_lines: int) -> np.ndarray:
    """Model-bank snapshot after replaying a precomputed (model, symbol)
    stream WITHOUT coding it — bank updates are independent of the
    arithmetic interval, so the primed bank the device lanes need is
    available before (and concurrently with) the warmup shard's actual
    payload coding."""
    lib = native.load()
    model_t = np.ascontiguousarray(model_t, dtype=np.uint32)
    qs_t = np.ascontiguousarray(qs_t, dtype=np.uint8)
    cl = (np.ascontiguousarray(cluster_ids, dtype=np.uint8)
          if cluster_ids is not None else None)
    ob = np.empty(tables.bank_words, dtype=np.uint32)
    lib.qvz_bank_from_stream(
        tables._h, _ptr(model_t, _u32p), _ptr(qs_t, _u8p),
        _ptr(cl, _u8p) if cl is not None else None,
        n_lines, _ptr(ob, _u32p))
    return ob


def decode_colmajor(tables: Tables, payload: bytes, n_lines: int,
                    well_state_words, out: np.ndarray | None = None,
                    init_bank: np.ndarray | None = None,
                    want_bank: bool = False,
                    cluster_out: bool = False,
                    draws_t: np.ndarray | None = None):
    """Decode a column-major shard payload to Phred+33 text lines.

    init_bank/want_bank: model-bank snapshot in/out (shard priming;
    the captured snapshot includes the final bookkeeping update so it
    matches the encoder's)."""
    lib = native.load()
    cols = tables.columns
    pay = np.frombuffer(payload, dtype=np.uint8)
    st = np.ascontiguousarray(well_state_words, dtype=np.uint32)
    if st.size < 32:  # Well's ctor memcpy's 32 words unconditionally
        raise ValueError("WELL state must be 32 words (128 bytes)")
    if out is None:
        out = np.empty(n_lines * (cols + 1), dtype=np.uint8)
    else:
        assert out.flags["C_CONTIGUOUS"] and out.dtype == np.uint8
        assert out.size == n_lines * (cols + 1)
    ib = (np.ascontiguousarray(init_bank, dtype=np.uint32)
          if init_bank is not None else None)
    ob = (np.empty(tables.bank_words, dtype=np.uint32)
          if want_bank else None)
    cl = np.empty(n_lines, dtype=np.uint8) if cluster_out else None
    dt = (np.ascontiguousarray(draws_t, dtype=np.uint8)
          if draws_t is not None else None)
    r = lib.qvz_decode_colmajor(tables._h, _ptr(pay, _u8p), len(pay),
                                n_lines, _ptr(st, _u32p), _ptr(out, _u8p),
                                _ptr(ib, _u32p) if ib is not None else None,
                                _ptr(ob, _u32p) if ob is not None else None,
                                _ptr(cl, _u8p) if cl is not None else None,
                                _ptr(dt, _u8p) if dt is not None else None)
    if r != 0:
        raise ValueError(f"decode failed with status {r}")
    out = out.reshape(n_lines, cols + 1)
    res = [out]
    if want_bank:
        res.append(ob)
    if cluster_out:
        res.append(cl)
    return tuple(res) if len(res) > 1 else out


def decode_cluster_prologue(tables: Tables, payload, n_lines: int,
                            init_bank: np.ndarray | None = None):
    """Decode the cluster-id segment opening a column-major shard and
    return (cluster_ids u8 (n,), l, u, t, consumed_bits) — the exact
    coder state where the lane decoder resumes. Model 0 is never touched
    again in column-major order, so its counts need not be exported. The
    host oracle of K5p, the device decode's prologue."""
    lib = native.load()
    pay = np.frombuffer(payload, dtype=np.uint8)
    cl = np.empty(max(n_lines, 1), dtype=np.uint8)
    st = np.zeros(4, dtype=np.uint64)
    ib = (np.ascontiguousarray(init_bank, dtype=np.uint32)
          if init_bank is not None else None)
    r = lib.qvz_decode_cluster_prologue(
        tables._h, _ptr(pay, _u8p), len(pay), n_lines,
        _ptr(ib, _u32p) if ib is not None else None,
        _ptr(cl, _u8p), _ptr(st, _u64p))
    if r != 0:
        raise ValueError(f"cluster prologue failed with status {r}")
    return cl[:n_lines], int(st[0]), int(st[1]), int(st[2]), int(st[3])


def decode_lines(tables: Tables, payload: bytes, n_lines: int,
                 well_state_words, out: np.ndarray | None = None,
                 cluster_out: bool = False, verbose: bool = False):
    """Decode the payload to Phred+33 text bytes with newlines.

    `out` may be a preallocated C-contiguous uint8 buffer of
    n_lines*(cols+1) bytes (e.g. a row-slice of a larger array) so
    sharded decodes write in place.
    """
    lib = native.load()
    cols = tables.columns
    pay = np.frombuffer(payload, dtype=np.uint8)
    st = np.ascontiguousarray(well_state_words, dtype=np.uint32)
    if st.size < 32:  # Well's ctor memcpy's 32 words unconditionally
        raise ValueError("WELL state must be 32 words (128 bytes)")
    if out is None:
        out = np.empty(n_lines * (cols + 1), dtype=np.uint8)
    else:
        assert out.flags["C_CONTIGUOUS"] and out.dtype == np.uint8
        assert out.size == n_lines * (cols + 1)
    cl = np.empty(n_lines, dtype=np.uint8) if cluster_out else None
    r = lib.qvz_decode_lines(tables._h, _ptr(pay, _u8p), len(pay),
                             n_lines, _ptr(st, _u32p), _ptr(out, _u8p),
                             _ptr(cl, _u8p) if cl is not None else None,
                             int(verbose))
    if r != 0:
        raise ValueError(f"decode failed with status {r}")
    out = out.reshape(n_lines, cols + 1)
    return (out, cl) if cluster_out else out
