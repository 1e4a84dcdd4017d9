"""Bounded-memory streaming encode (counterpart of
``qvz_tpu.pipeline.streaming``).

The in-memory encode (pipeline/encode.py) holds the whole (N, cols)
matrix, on the host and on the card. This driver keeps both at about one
chunk or one shard:

  1. k-means (-c K > 1): Lloyd iterations over chunks of the memmap on
     the host (``rt.kmeans_iter``), integer accumulators merged, ids kept
     as one uint8 a read, bit-identical to every other path
  2. statistics: each chunk uploaded to `device` and counted by K3
     (``ops/stats``); the int64 counts accumulate there and come to the
     host once, after the last chunk
  3. design on the host, unchanged
  4. coding: for each shard, its WELL dither drawn on the host, its rows
     and draws uploaded, K1 (``ops/quantize``) run on them and its
     outputs narrowed (qs and qv to uint8) before the copy back; one
     shard's device leg at a time, under one lock on the default stream.
     Host threads code the adaptive arithmetic streams from K1's
     outputs, and a sequential writer appends the payloads in shard
     order (out-of-order completions wait, bounded by the thread count)
     and fills in the shard directory at the end
  5. the container is byte-identical to ``qvz_tpu``'s streaming encode
     and to the in-memory encode for the same shard plan

On ``device="cpu"`` the same code runs the kernels' plain versions.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from qvz_tpu_torch.constants import (ALPHABET_SIZE, MAX_KMEANS_ITERATIONS,
                                     MODE_RATIO, PHRED_OFFSET)
from qvz_tpu_torch.device import resolve
from qvz_tpu_torch.format import container_v2
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops import quantize
from qvz_tpu_torch.ops import stats as dev_stats
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline.host import (_drop_pages, _flush_drop,
                                         _geometry, _rows, shard_plan)
from qvz_tpu_torch.spec import kmeans as spec_kmeans

A = ALPHABET_SIZE


def _kmeans_chunked(mm, n, columns, n_clusters, cluster_threshold,
                    chunk_lines, verbose) -> tuple[np.ndarray, int]:
    """The reference's k-means over chunks of the memmap on the host: the
    seeds of ``spec.kmeans.seed_rows``, one ``rt.kmeans_iter`` a chunk
    and iteration. Returns (ids, iterations)."""
    means = np.stack([_rows(mm, columns, g, g + 1)[0] for g in
                      spec_kmeans.seed_rows(n, n_clusters, verbose=verbose)]
                     ).astype(np.int64)
    assign = np.empty(n, dtype=np.uint8)
    iters = 0
    while iters < MAX_KMEANS_ITERATIONS:
        sums = np.zeros((n_clusters, columns), dtype=np.int64)
        cnts = np.zeros(n_clusters, dtype=np.int64)
        for lo in range(0, n, chunk_lines):
            hi = min(n, lo + chunk_lines)
            a, s_, c_ = rt.kmeans_iter(_rows(mm, columns, lo, hi), means)
            assign[lo:hi] = a
            sums += s_
            cnts += c_
        iters += 1
        means, stop = spec_kmeans.update_means(means, sums, cnts,
                                               cluster_threshold, verbose)
        if stop:
            break
    if verbose:
        spec_kmeans.verbose_total(iters)
    return assign, iters


def _stats_chunked(mm, n, columns, assign, n_clusters, chunk_lines,
                   dev: torch.device):
    """K3 over each chunk on `dev`, the int64 counts accumulated there and
    copied to the host once. Returns (counts0, cond) int64 numpy."""
    acc0 = torch.zeros((n_clusters, A), dtype=torch.long, device=dev)
    accc = torch.zeros((n_clusters, columns - 1, A, A), dtype=torch.long,
                       device=dev)
    for lo in range(0, n, chunk_lines):
        hi = min(n, lo + chunk_lines)
        rows = torch.from_numpy(_rows(mm, columns, lo, hi)).to(dev)
        cl = (torch.from_numpy(assign[lo:hi]).to(dev)
              if assign is not None else None)
        c0, cond = dev_stats.conditional_counts(rows, cl, n_clusters)
        acc0 += c0
        accc += cond
        del rows, cl, c0, cond
        if n_clusters == 1:
            # one cluster: nothing reads this range again before its own
            # shard codes it
            _drop_pages(mm, columns, lo, hi)
    return acc0.cpu().numpy(), accc.cpu().numpy()


def encode_streaming(input_path: str, output_path: str, *,
                     n_clusters: int = 1, mode: int = MODE_RATIO,
                     ratio: float = 0.5, cluster_threshold: float = 4.0,
                     well_state: WellState | None = None,
                     dist_matrix: np.ndarray | None = None,
                     shards: int = 0,
                     max_shard_lines: int = 1_000_000,
                     chunk_lines: int = 1_000_000,
                     prime: bool = True,
                     reuse_blocks: bytes | None = None,
                     recon_path: str | None = None,
                     device: str | torch.device = "cuda",
                     verbose: bool = False) -> dict:
    """Encode a quality file to a QVZ2 container with bounded memory.

    Returns qvz_tpu's stats dict (lines, columns, kmeans_iters at -c K,
    cluster_s, stats_s, design_s, code_s, total_s, payload_bytes, rate,
    distortion, shards) and device_peak_bytes, the most device memory
    the encode held (``torch.cuda.max_memory_allocated``; 0 on the CPU).

    shards == 0 picks max(CPUs, ceil(N / max_shard_lines)).
    reuse_blocks: codebook blocks of an earlier container; skips the
    statistics and the design. recon_path: write the lossy
    reconstruction (`-u`, Phred+33 text with newlines) to this file, a
    shard at a time through a memory-mapped output."""
    dev = resolve(device)
    if well_state is None:
        well_state = WellState.debug()
    if dist_matrix is None:
        from qvz_tpu_torch.constants import DISTORTION_MSE
        from qvz_tpu_torch.ops.distortion import make_matrix
        dist_matrix = make_matrix(DISTORTION_MSE)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    n, columns = _geometry(input_path)
    if hasattr(os, "posix_fadvise"):
        try:
            fd = os.open(input_path, os.O_RDONLY)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_SEQUENTIAL)
            os.close(fd)
        except OSError:
            pass
    mm = np.memmap(input_path, dtype=np.uint8, mode="r")
    stats = {"lines": n, "columns": columns}
    t0 = time.perf_counter()

    assign = None
    if n_clusters > 1:
        assign, stats["kmeans_iters"] = _kmeans_chunked(
            mm, n, columns, n_clusters, cluster_threshold, chunk_lines,
            verbose)
    t1 = time.perf_counter()
    stats["cluster_s"] = t1 - t0

    if reuse_blocks is not None:
        # the codebooks fully determine the coder
        tables = rt.tables_from_blocks(reuse_blocks, n_clusters, columns)
        blocks = reuse_blocks[:tables.consumed]
        t3 = time.perf_counter()
        stats["stats_s"] = 0.0
        stats["design_s"] = t3 - t1
    else:
        counts0, cond = _stats_chunked(mm, n, columns, assign, n_clusters,
                                       chunk_lines, dev)
        t2 = time.perf_counter()
        stats["stats_s"] = t2 - t1
        design = rt.Design(counts0, cond, mode, ratio, dist_matrix)
        blocks = design.serialized()
        tables = design.tables()
        t3 = time.perf_counter()
        stats["design_s"] = t3 - t2

    ncpu = os.cpu_count() or 1
    if shards == 0:
        shards = max(ncpu, -(-n // max_shard_lines))
    shards = max(1, min(shards, n))
    counts, states, offs, prime_on = shard_plan(n, columns, shards, prime,
                                                well_state)
    S = len(counts)
    tabs = quantize.tables_to_torch(tables, dev)

    # header, blocks, file state and a directory placeholder; payloads
    # appended in shard order; the directory filled in at the end
    state_bytes = [np.asarray(st, dtype="<u4").tobytes() for st in states]
    head = container_v2.head(blocks, n_clusters, columns, n, S,
                             state_bytes[0], priming=1 if prime_on else 0)
    out_f = open(output_path, "wb")
    out_f.write(head)
    out_f.write(b"\x00" * (S * container_v2.DIR_ENTRY_SIZE))

    payload_meta = [None] * S  # (length, checksum)
    pending = {}
    next_to_write = 0
    dist_total = 0.0
    recon_mm = None
    if recon_path is not None:
        recon_mm = np.memmap(recon_path, dtype=np.uint8, mode="w+",
                             shape=(n, columns + 1))

    def write_ready(s, payload):
        nonlocal next_to_write
        pending[s] = payload
        while next_to_write in pending:
            p = pending.pop(next_to_write)
            payload_meta[next_to_write] = (len(p), rt.xxh64(p))
            out_f.write(p)
            next_to_write += 1

    dlock = threading.Lock()

    def quantize_shard(rows, draws, cl):
        """The shard's device leg, one shard at a time: upload, K1, the
        narrowing and the copy back. Returns (mid u32, qs u8, qv u8),
        each (cols, n) numpy."""
        with dlock:
            data_t = torch.from_numpy(rows).to(dev).t().contiguous()
            draws_t = torch.from_numpy(draws).to(dev).t().contiguous()
            cl_t = torch.from_numpy(cl).to(dev) if cl is not None else None
            mid, qs, qv = quantize.quantize_t_device(tabs, data_t, draws_t,
                                                     cl_t)
            # mid < 2**31: its int32 bits are the uint32 the coder reads
            out = (mid.cpu().numpy().view(np.uint32),
                   qs.to(torch.uint8).cpu().numpy(),
                   qv.to(torch.uint8).cpu().numpy())
            del data_t, draws_t, cl_t, mid, qs, qv
        return out

    def code_shard(s, init_bank=None, want_bank=False):
        lo, hi = int(offs[s]), int(offs[s + 1])
        cl = assign[lo:hi] if assign is not None else None
        rows = _rows(mm, columns, lo, hi)
        draws = rt.well_draws7(states[s], (hi - lo) * columns).reshape(
            hi - lo, columns)
        md_t, qs_t, qv_t = quantize_shard(rows, draws, cl)
        out = rt.encode_precomputed_colmajor(
            tables, md_t, qs_t, cl, hi - lo, init_bank=init_bank,
            want_bank=want_bank)
        pay, bank_out = out if want_bank else (out, None)
        dsum = float(dist_matrix[rows.reshape(-1),
                                 qv_t.T.reshape(-1)].sum()) / columns
        if recon_mm is not None:
            recon_mm[lo:hi, :columns] = qv_t.T + PHRED_OFFSET
            recon_mm[lo:hi, columns] = ord("\n")
            _flush_drop(recon_mm, columns + 1, lo, hi)
        _drop_pages(mm, columns, lo, hi)
        return pay, dsum, bank_out

    try:
        bank = None
        first = 0
        if prime_on:
            p0, d0, bank = code_shard(0, want_bank=True)
            dist_total += d0
            write_ready(0, p0)
            first = 1
        wlock = threading.Lock()

        def worker(s):
            nonlocal dist_total
            pay, dsum, _ = code_shard(s, init_bank=bank)
            with wlock:
                write_ready(s, pay)
                dist_total += dsum

        with ThreadPoolExecutor(max_workers=ncpu) as ex:
            list(ex.map(worker, range(first, S)))
        assert next_to_write == S
        if recon_mm is not None:
            recon_mm.flush()
            del recon_mm
        out_f.seek(len(head))
        for s in range(S):
            out_f.write(container_v2.dir_entry(int(counts[s]),
                                               *payload_meta[s],
                                               state_bytes[s]))
    finally:
        out_f.close()
    t4 = time.perf_counter()
    stats["code_s"] = t4 - t3

    payload_bytes = sum(m[0] for m in payload_meta)
    stats["payload_bytes"] = payload_bytes
    stats["rate"] = payload_bytes * 8.0 / (float(n) * columns)
    stats["distortion"] = dist_total / n
    stats["total_s"] = t4 - t0
    stats["shards"] = S
    stats["device_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else 0)
    return stats
