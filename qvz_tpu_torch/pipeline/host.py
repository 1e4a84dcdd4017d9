"""The host engine: the port's pure C++ encode and decode.

The counterpart of ``qvz_tpu.pipeline.encode.encode(use_jax=False)`` and
of the host branches of ``qvz_tpu.pipeline.decode``, over the port's copy
of the C++ runtime (``qvz_tpu_torch.native``). Its containers are
byte-equal to ``qvz_tpu``'s host encode for the same shards, priming and
WELL seed, and its decode gives ``qvz_tpu``'s host decoder's bytes. It
decodes the containers that have no lanes (v1, row-major QVZ2 and
single-shard QVZ2), codes the single-stream v1 container of
``encode(shards=1)``, and is the reference that ``chip_smoke.py`` holds the
device paths against.

Encode: k-means and statistics on host threads, the codebook design, then
either one fused quantize + code pass over every line (v1, shards == 1,
reference order) or one column-major fused pass per shard on a thread
pool (QVZ2), with the primed warmup shard first when priming is on.
"""

from __future__ import annotations

import contextlib
import functools
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from qvz_tpu_torch.constants import MODE_RATIO, PHRED_OFFSET
from qvz_tpu_torch.format import container, container_v2
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops.well import WellState


@dataclass
class EncodeStats:
    lines: int = 0
    columns: int = 0
    payload_bytes: int = 0
    distortion: float = 0.0
    rate: float = 0.0
    phase_seconds: dict = field(default_factory=dict)
    # The subset of phase_seconds that ran on the device, transfers
    # included; phases absent here ran on the host.
    device_seconds: dict = field(default_factory=dict)
    # Device-coder lanes re-coded on the host (a rescaling column model
    # or an oversize emission).
    coder_fallback_lanes: int = 0
    # Counts the device encode takes where the work happens: h2d_bytes,
    # lloyd_iters, lloyd_discarded_iters (pipeline/encode.py).
    counters: dict = field(default_factory=dict)


@dataclass
class EncodeOutput:
    compressed: bytes
    reconstructed: np.ndarray  # (N, cols) quantized symbols
    clusters: np.ndarray
    stats: EncodeStats


# Warmup-shard size for primed QVZ2 encodes: shard 0 is capped at this
# many lines so the serial warmup stage stays a small fraction of the
# wall time while the adaptive models still see enough symbols to
# converge (the adaptation redundancy is concentrated in each model's
# first ~hundred updates). Overridable for experiments.
PRIME_WARMUP_LINES = int(os.environ.get("QVZ_TPU_WARMUP_LINES", 65536))


def _shard_plan(n: int, columns: int, shards: int, warmup: int = 0):
    """Split n lines into <= `shards` contiguous shards whose dither-draw
    offsets land on WELL pool-word boundaries (4 draws per 32-bit pool
    word, well.c:33-46), so jump-ahead start states are exact.

    warmup > 0: shard 0 is a warmup shard of ~`warmup` lines (model-bank
    priming source); the remaining lines split evenly across the other
    shards."""
    if warmup > 0 and shards > 1 and n > 2 * warmup:
        # the warmup shard is an extra small shard: the parallel stage
        # still splits the rest over `shards`
        w = max(4, (min(warmup, n // 2) + 3) & ~3)
        rest = n - w
        per = -(-rest // shards)
        per = max(4, (per + 3) & ~3)
        counts = [w]
        left = rest
        while left > 0:
            take = min(per, left)
            counts.append(take)
            left -= take
        return counts
    per = -(-n // shards)
    per = max(4, (per + 3) & ~3)  # multiple of 4 => 4 | per*columns
    counts = []
    left = n
    while left > 0:
        take = min(per, left)
        counts.append(take)
        left -= take
    return counts


def _state_words(well_state: WellState) -> np.ndarray:
    order = [(well_state.n + i) & 31 for i in range(32)]
    return np.asarray(well_state.state, dtype=np.uint32)[order]


def shard_counts(n: int, columns: int, shards: int, prime: bool):
    """Lines per shard of the QVZ2 plan, and whether shard 0 is a priming
    warmup shard (``shard_plan`` without the WELL states)."""
    # Adaptive warmup: an eighth of the file, capped.
    warmup = min(PRIME_WARMUP_LINES, max(8192, n // 12)) if prime else 0
    prime_on = warmup > 0 and shards > 1 and n > 2 * warmup
    counts = _shard_plan(n, columns, shards,
                         warmup=warmup if prime_on else 0)
    return counts, prime_on and len(counts) > 1


def shard_plan(n: int, columns: int, shards: int, prime: bool,
               well_state: WellState):
    """The QVZ2 plan for shards >= 2: lines per shard, the per-shard WELL
    start states (S, 32), line offsets (S+1,) and whether shard 0 is a
    priming warmup shard. Shard s starts counts[0..s)*columns draws into
    the single logical WELL stream."""
    state_words = _state_words(well_state)
    counts, prime_on = shard_counts(n, columns, shards, prime)
    if prime_on:
        # non-uniform plan: jump over the warmup shard, then equal
        # chunks from there
        base2 = rt.well_jump(state_words, 2, counts[0] * columns // 4)
        rest = rt.well_jump(base2[1], len(counts) - 1,
                            counts[1] * columns // 4)
        states = np.vstack([state_words[None, :], rest])
    else:
        states = rt.well_jump(state_words, len(counts),
                              counts[0] * columns // 4)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return counts, states, offs, prime_on


def _shard_draws(states: np.ndarray, counts, columns: int) -> np.ndarray:
    """All 7-bit dither draws for the file in (line, col) order, filled
    in parallel from the per-shard GF(2) jump-ahead start states (the
    single logical WELL stream split at pool-word boundaries)."""
    n = int(sum(counts))
    draws = np.empty((n, columns), dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def fill(s):
        lo, hi = offs[s], offs[s + 1]
        draws[lo:hi] = rt.well_draws7(
            states[s], (hi - lo) * columns).reshape(hi - lo, columns)

    with ThreadPoolExecutor(max_workers=min(len(counts),
                                            os.cpu_count() or 1)) as ex:
        list(ex.map(fill, range(len(counts))))
    return draws


def encode(data: np.ndarray, dist_matrix: np.ndarray, *,
           n_clusters: int = 1, mode: int = MODE_RATIO, ratio: float = 0.5,
           cluster_threshold: float = 4.0,
           well_state: WellState | None = None,
           shards: int = 1,
           want_recon: bool = True,
           prime: bool = True,
           verbose: bool = False) -> EncodeOutput:
    """Encode (N, cols) uint8 symbols on the host: the v1 container for
    shards == 1, QVZ2 for shards >= 2, one shard per CPU for shards == 0.
    prime (QVZ2 only): shards 1.. start their adaptive models from the
    bank state after a small warmup shard 0."""
    n, columns = data.shape
    if shards == 0:
        shards = os.cpu_count() or 1
    shards = max(1, min(shards, n))
    if well_state is None:
        well_state = WellState.debug()
    st = EncodeStats(lines=n, columns=columns)
    t0 = time.perf_counter()
    clusters, _, _ = rt.kmeans_host(data, n_clusters, cluster_threshold,
                                    verbose=verbose)
    t1 = time.perf_counter()
    st.phase_seconds["cluster"] = t1 - t0
    if verbose:
        print(f"Clustering took {t1 - t0:.4f} seconds")

    counts0, cond = rt.stats_host(data, clusters if n_clusters > 1 else None,
                                  n_clusters)
    t2 = time.perf_counter()
    st.phase_seconds["stats"] = t2 - t1
    design = rt.Design(counts0, cond, mode, ratio, dist_matrix)
    blocks = design.serialized()
    tables = design.tables()
    t3 = time.perf_counter()
    st.phase_seconds["design"] = t3 - t2
    if verbose:
        print(f"Stats and codebook generation took {t3 - t1:.4f} seconds")

    cl = clusters if n_clusters > 1 else None
    if shards == 1:
        compressed, payload_bytes, recon, dist_sum = encode_v1(
            tables, blocks, data, cl, n_clusters, well_state, dist_matrix,
            want_recon, verbose)
    else:
        compressed, payload_bytes, recon, dist_sum = _encode_v2(
            tables, blocks, data, cl, n_clusters, shards, well_state,
            dist_matrix, want_recon, prime)
    st.phase_seconds["code"] = time.perf_counter() - t3
    st.payload_bytes = payload_bytes
    st.rate = (payload_bytes * 8.0) / (float(n) * columns)
    st.distortion = dist_sum / n
    return EncodeOutput(compressed, recon, clusters, st)


def encode_v1(tables, blocks, data, clusters, n_clusters, well_state,
              dist_matrix, want_recon, verbose=False):
    """The single-stream v1 container: every line in the reference's
    order through one fused quantize + code pass. clusters: (N,) uint8 or
    None with one cluster. Returns (container, payload bytes, recon or
    None, distortion sum)."""
    n, columns = data.shape
    payload, recon, dist_sum = rt.encode_fused(
        tables, data, clusters, _state_words(well_state), dist=dist_matrix,
        want_recon=want_recon, verbose=verbose)
    compressed = container.build_container_raw(
        blocks, n_clusters, well_state.to_bytes(), payload, columns, n)
    return compressed, len(payload), recon, dist_sum


def _encode_v2(tables, blocks, data, clusters, n_clusters, shards,
               well_state, dist_matrix, want_recon, prime):
    """QVZ2: one column-major fused pass per shard on a thread pool, the
    primed warmup shard first."""
    n, columns = data.shape
    counts, states, offs, prime_on = shard_plan(n, columns, shards, prime,
                                                well_state)

    def run(s, init_bank=None, want_bank=False):
        lo, hi = offs[s], offs[s + 1]
        # each worker transposes its own shard (one copy each)
        return rt.encode_fused_colmajor(
            tables, np.ascontiguousarray(data[lo:hi].T),
            clusters[lo:hi] if clusters is not None else None,
            states[s], dist=dist_matrix, want_recon=want_recon,
            init_bank=init_bank, want_bank=want_bank)

    if prime_on:
        # serial warmup stage: shard 0 derives the shared prior
        p0, r0, d0, bank = run(0, want_bank=True)
        with ThreadPoolExecutor(
                max_workers=min(len(counts) - 1,
                                os.cpu_count() or 1)) as ex:
            results = [(p0, r0, d0)] + list(ex.map(
                lambda s: run(s, init_bank=bank), range(1, len(counts))))
    else:
        with ThreadPoolExecutor(
                max_workers=min(len(counts), os.cpu_count() or 1)) as ex:
            results = list(ex.map(run, range(len(counts))))
    payloads = [r[0] for r in results]
    dist_sum = float(sum(r[2] for r in results))
    recon = (np.concatenate([r[1] for r in results])
             if want_recon else None)
    shard_states = [np.asarray(states[s], dtype="<u4").tobytes()
                    for s in range(len(counts))]
    compressed = container_v2.build(
        blocks, n_clusters, columns, n, counts, shard_states, payloads,
        priming=1 if prime_on else 0)
    return compressed, sum(len(p) for p in payloads), recon, dist_sum


# ---------------------------------------------------------------------------
# Decode


def _malformed_raises_valueerror(fn):
    """A malformed or hostile container always surfaces as ValueError,
    whatever the parsing internals tripped over (short-buffer slicing,
    struct unpacking). MemoryError/OverflowError are not converted here:
    a host OOM while decoding a large, valid container is a resource
    failure and surfaces as MemoryError. Those two are converted only
    inside `_parsing()` blocks, where absurd claimed sizes from a hostile
    header are the plausible cause."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (IndexError, struct.error) as e:
            raise ValueError(
                f"malformed container ({type(e).__name__}: {e})") from e
    return wrapper


@contextlib.contextmanager
def _parsing():
    """Header/geometry/table parsing stage: here an OverflowError (ctypes
    width conversion) or MemoryError (allocator fed a hostile claimed
    size) is evidence of a malformed container."""
    try:
        yield
    except (IndexError, OverflowError, MemoryError, struct.error) as e:
        raise ValueError(
            f"malformed container ({type(e).__name__}: {e})") from e


def _sane_output_size(lines: int, columns: int) -> None:
    """Corrupt headers can claim absurd geometry; decoding then costs
    O(lines) even when the payload is tiny. Cap the claimed output size
    (default 1 TB, QVZ_TPU_MAX_DECODE_BYTES overrides)."""
    cap = int(os.environ.get("QVZ_TPU_MAX_DECODE_BYTES", 1 << 40))
    if lines * (columns + 1) > cap:
        raise ValueError(
            f"container claims {lines}x{columns} output "
            f"(> {cap} bytes); refusing (set QVZ_TPU_MAX_DECODE_BYTES "
            f"to raise)")


def _flush_drop(mm: np.ndarray, row_bytes: int, lo: int, hi: int) -> None:
    """msync then release the pages backing output rows [lo, hi) of a
    writable memmap, so a large decode's dirty pages do not pile up in
    the resident set until the final flush. The range flush lands first:
    MADV_DONTNEED on still-dirty pages discards the data."""
    try:
        import mmap as _mmap

        raw = mm._mmap
        page = 4096
        start = (lo * row_bytes) // page * page
        end = hi * row_bytes // page * page
        if end > start:
            raw.flush(start, end - start)
            raw.madvise(_mmap.MADV_DONTNEED, start, end - start)
    except (AttributeError, ValueError, OSError):
        pass  # advisory only


# ---------------------------------------------------------------------------
# A quality file read through a memmap a range of rows at a time (the
# helpers of qvz_tpu.pipeline.streaming, which the streaming encode and
# the multi-host workers share; here, so that a worker that needs no
# device does not import torch).


def _geometry(path: str):
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        first = f.readline()
    columns = len(first) - 1
    if columns <= 0:
        raise ValueError("empty or malformed quality file")
    return size // (columns + 1), columns


def _rows(mm: np.ndarray, columns: int, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) as 0-based symbols (one chunk copy)."""
    return np.ascontiguousarray(
        mm.reshape(-1, columns + 1)[lo:hi, :columns] - PHRED_OFFSET)


def _rows_t(mm: np.ndarray, columns: int, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) as a (cols, n) column-major symbol buffer: one
    shard-sized allocation (transpose, then the Phred strip in place)."""
    dt = np.ascontiguousarray(
        mm.reshape(-1, columns + 1)[lo:hi, :columns].T)
    dt -= PHRED_OFFSET  # uint8 wrap semantics, as everywhere
    return dt


def _drop_pages(mm: np.ndarray, columns: int, lo: int, hi: int) -> None:
    """Release the page-cache pages backing rows [lo, hi), so the
    streaming pass's resident set stays at about a chunk."""
    try:
        import mmap as _mmap

        raw = mm._mmap  # np.memmap's underlying mmap object
        page = 4096
        start = (lo * (columns + 1)) // page * page
        end = hi * (columns + 1) // page * page
        if end > start:
            raw.madvise(_mmap.MADV_DONTNEED, start, end - start)
    except (AttributeError, ValueError, OSError):
        pass  # advisory only


@_malformed_raises_valueerror
def decode(compressed, out: np.ndarray | None = None,
           verbose: bool = False) -> np.ndarray:
    """Decode a v1 or QVZ2 container on the host to Phred+33 text bytes
    (lines, cols+1) with newlines (QVZ2: one host thread per shard).
    `out` may be a preallocated (lines, cols+1) uint8 buffer, e.g. an
    np.memmap, written in place."""
    if container_v2.is_v2(compressed):
        return _decode_v2(compressed, out)
    with _parsing():
        cluster_count, columns, lines = container.read_header(
            compressed[:9])
        _sane_output_size(lines, columns)
        tables = rt.tables_from_blocks(compressed[9:], cluster_count,
                                       columns)
    pos = 9 + tables.consumed
    well_words = np.frombuffer(compressed[pos:pos + 128], dtype="<u4")
    payload = compressed[pos + 128:]
    return rt.decode_lines(
        tables, payload, lines, well_words,
        out=out.reshape(-1) if out is not None else None,
        verbose=verbose)


def _decode_v2(compressed, out: np.ndarray | None = None) -> np.ndarray:
    with _parsing():
        head = container_v2.parse(compressed, blocks_len=None)
        hdr = container_v2.header_size()
        tables = rt.tables_from_blocks(compressed[hdr:],
                                       head.cluster_count, head.columns)
        head = container_v2.parse(compressed, blocks_len=tables.consumed)
        cols = head.columns
        _sane_output_size(head.lines, cols)
    if out is None:
        out = np.empty((head.lines, cols + 1), dtype=np.uint8)
    offs = np.concatenate(
        [[0], np.cumsum([s.lines for s in head.shards])]).astype(np.int64)
    dec_fn = (rt.decode_colmajor if head.order == container_v2.ORDER_COL
              else rt.decode_lines)

    def _writeback(i):
        if isinstance(out, np.memmap):
            _flush_drop(out, cols + 1, int(offs[i]), int(offs[i + 1]))

    def run(i, init_bank=None, want_bank=False, draws_t=None):
        s = head.shards[i]
        well = np.frombuffer(s.well_state, dtype="<u4")
        payload = compressed[s.payload_off:s.payload_off + s.payload_len]
        if rt.xxh64(payload) != s.checksum:
            raise ValueError(
                f"shard {i} payload checksum mismatch (corrupt container)")
        if init_bank is not None or want_bank or draws_t is not None:
            if head.order != container_v2.ORDER_COL:
                raise ValueError("primed QVZ2 requires column-major order")
            r = rt.decode_colmajor(
                tables, payload, s.lines, well,
                out=out[offs[i]:offs[i + 1]].reshape(-1),
                init_bank=init_bank, want_bank=want_bank, draws_t=draws_t)
            _writeback(i)
            return r
        dec_fn(tables, payload, s.lines, well,
               out=out[offs[i]:offs[i + 1]].reshape(-1))
        _writeback(i)

    if head.priming and len(head.shards) > 1:
        # Primed container: shard 0's decode is a serial stage (it
        # derives the shared prior). Overlap it with the other shards'
        # dither-draw generation and transpose.
        bank_box = {}
        ready = threading.Event()

        def warmup():
            # ready is set even on failure, or every worker would block
            # in ready.wait() instead of surfacing the error
            try:
                _, bank_box["bank"] = run(0, want_bank=True)
            except BaseException as e:  # raised again on the caller's thread
                bank_box["err"] = e
            finally:
                ready.set()

        wt = threading.Thread(target=warmup)
        wt.start()

        def prep_and_decode(i):
            s = head.shards[i]
            well = np.frombuffer(s.well_state, dtype="<u4")
            draws_t = np.ascontiguousarray(rt.well_draws7(
                well, s.lines * cols).reshape(s.lines, cols).T)
            ready.wait()
            if "err" in bank_box:
                return None  # the warmup failed; raised below
            return run(i, init_bank=bank_box["bank"], draws_t=draws_t)

        with ThreadPoolExecutor(
                max_workers=min(len(head.shards) - 1,
                                os.cpu_count() or 1)) as ex:
            list(ex.map(prep_and_decode, range(1, len(head.shards))))
        wt.join()
        if "err" in bank_box:
            raise bank_box["err"]
    else:
        with ThreadPoolExecutor(
                max_workers=min(len(head.shards),
                                os.cpu_count() or 1)) as ex:
            list(ex.map(run, range(len(head.shards))))
    return out
