"""Conditional statistics on the device (reference: src/codebook.c:185-220).

Counts of (cluster, previous symbol, symbol) for every pair of adjacent
columns, plus the first column's histogram per cluster: the contract of
``qvz_tpu.ops.stats.conditional_counts``. The CUDA kernel K3
(``csrc/hist.cu``) replaces ``qvz_tpu.ops.pallas_kernels._hist_kernel``
and the XLA scan ``qvz_tpu.ops.stats._hist_device``; its plain PyTorch
version is ``conditional_counts_reference`` (``torch.bincount``, exact
integer counts in int64). K3's launch shape comes from ``hist_shape``.
"""

from __future__ import annotations

import functools

import torch

from qvz_tpu_torch.constants import ALPHABET_SIZE
from qvz_tpu_torch import _build

BINS = ALPHABET_SIZE * ALPHABET_SIZE
THREADS = 512        # a block's threads where two blocks share an SM
GROUP = 16           # reads a thread takes at once (csrc/hist.cu kGroup)
SMEM_RESERVED = 1024            # shared memory the card keeps for a block
MAX_SLICE = 2 ** 31             # u32 counts: a block takes fewer reads
MAX_SHARED_CLUSTERS = 12        # mode 0 keeps a bin's key in 16 bits
BYTES_SLACK = 1.25   # two blocks an SM unless they read this much more
TAIL = 0.95          # the least share of the card the last wave fills


def layout_bytes(cols: int, c: int, band: int) -> int:
    """Shared memory of one K3 block in mode 0: column 0's c x 72 uint32
    counts and c x 72 x 72 for each of the band's pairs (at most cols -
    1)."""
    return 4 * (c * ALPHABET_SIZE + min(band, cols - 1) * c * BINS)


def _read_bytes(n: int, pairs: int, band: int, c: int) -> int:
    """Bytes K3 reads at this band: each column once a band, the band's
    first previous column again, and the cluster ids once a band."""
    bands = -(-pairs // band) if pairs else 1
    return n * (pairs + bands) + (n * bands if c > 1 else 0)


def hist_shape(n: int, cols: int, c: int, smem_block: int, smem_sm: int,
               sms: int) -> dict:
    """K3's launch shape for n reads of `cols` columns and c clusters on a
    card of `sms` SMs with smem_block bytes of shared memory a block and
    smem_sm an SM.

    mode: 0 where one pair's c x 72 x 72 counters fit in a block's shared
    memory (and c <= MAX_SHARED_CLUSTERS), else 1: the increments go to
    the output in device memory. band: the column pairs a block counts.
    Mode 0 runs two blocks of THREADS an SM, the band as wide as that
    leaves shared memory for, unless that band makes the call read more
    than BYTES_SLACK times the bytes of one block of 2 x THREADS an SM
    with the widest band that fits alone; mode 1 two blocks of THREADS.
    The band then narrows until the card's threads have at least one
    group of GROUP reads each. slice: the reads a block takes, a multiple
    of GROUP below MAX_SLICE; nslices: the fewest slices whose blocks
    fill at least TAIL of the card's last wave, else the best fill (every
    thread keeping a group). The grid is (nslices, nbands)."""
    if n < 1 or cols < 1 or not 1 <= c <= 255:
        raise ValueError(f"no K3 shape for {n} reads, {cols} columns and "
                         f"{c} clusters")
    pairs = cols - 1
    wide = max(pairs, 1)
    plans = []
    if c <= MAX_SHARED_CLUSTERS and layout_bytes(cols, c, 1) <= smem_block:
        for per_sm, threads in ((2, THREADS), (1, 2 * THREADS)):
            fits = [b for b in range(1, wide + 1)
                    if layout_bytes(cols, c, b) <= smem_block
                    and per_sm * (layout_bytes(cols, c, b) + SMEM_RESERVED)
                    <= smem_sm]
            if fits:
                plans.append((0, per_sm, threads, fits[-1]))
        two = [p for p in plans if p[1] == 2]
        one = [p for p in plans if p[1] == 1]
        if two and one and _read_bytes(n, pairs, two[0][3], c) \
                > BYTES_SLACK * _read_bytes(n, pairs, one[0][3], c):
            plans = one
    if not plans:
        plans = [(1, 2, THREADS, wide)]
    mode, per_sm, threads, band = plans[0]
    need = -(-per_sm * sms * threads * GROUP // n)
    band = min(band, max(1, pairs // need))
    nbands = -(-pairs // band) if pairs else 1
    resident = per_sm * sms
    s_min = -(-n // (MAX_SLICE - GROUP))
    s_max = max(s_min, -(-n // (GROUP * threads)))

    def fill(s):
        blocks = nbands * s
        return blocks / (-(-blocks // resident) * resident)

    tries = range(s_min, min(s_max, s_min + resident) + 1)
    s = next((s for s in tries if fill(s) >= TAIL),
             max(tries, key=lambda s: (fill(s), -s)))
    slice_ = -(-(-(-n // s)) // GROUP) * GROUP
    nslices = -(-n // slice_)
    return {"mode": mode, "band": band,
            "nbands": nbands, "slice": slice_, "nslices": nslices,
            "threads": threads, "blocks_per_sm": per_sm,
            "smem": layout_bytes(cols, c, band) if mode == 0 else 0,
            "fill": fill(nslices)}


@functools.lru_cache(maxsize=None)
def _card(dev: int) -> tuple:
    block, sm = _build.smem_limits()
    return block, sm, torch.cuda.get_device_properties(
        dev).multi_processor_count


_card_shape = functools.lru_cache(maxsize=64)(hist_shape)


def card_hist_shape(data_t: torch.Tensor, c: int) -> dict:
    """``hist_shape`` for the (cols, N) reads `data_t` and c clusters on
    the current card; the card's limits and each plan are worked out
    once (the planner's loops cost a call more than the kernel). The
    plan is shared between calls: read it, do not change it."""
    cols, n = data_t.shape
    return _card_shape(n, cols, c, *_card(data_t.get_device()))


def conditional_counts_reference(data_t: torch.Tensor,
                                 clusters: torch.Tensor | None,
                                 n_clusters: int):
    """Plain PyTorch version of K3 on the (cols, N) symbols: one
    ``torch.bincount`` per column. Returns (counts0, cond) as
    ``conditional_counts_t``."""
    A = ALPHABET_SIZE
    cols, n = data_t.shape
    dev = data_t.device
    base = (torch.zeros(n, dtype=torch.long, device=dev)
            if clusters is None else clusters.long() * A)
    counts0 = torch.bincount(base + data_t[0].long(),
                             minlength=n_clusters * A)
    pairs = max(cols - 1, 0)
    cond = torch.empty((pairs, n_clusters * A * A), dtype=torch.long,
                       device=dev)
    for c in range(1, cols):
        idx = (base + data_t[c - 1].long()) * A + data_t[c].long()
        cond[c - 1] = torch.bincount(idx, minlength=n_clusters * A * A)
    cond = cond.reshape(pairs, n_clusters, A, A).permute(1, 0, 2, 3)
    return counts0.reshape(n_clusters, A), cond.contiguous()


def _check(data_t, clusters, n_clusters):
    if data_t.dtype != torch.uint8 or data_t.dim() != 2:
        raise TypeError("data_t must be (cols, N) uint8")
    if not 1 <= n_clusters <= 255:
        raise ValueError(f"n_clusters {n_clusters} outside 1..255")
    if clusters is not None:
        if clusters.dtype != torch.uint8 \
                or clusters.shape != (data_t.shape[1],):
            raise ValueError("clusters must be (N,) uint8")
        if clusters.device != data_t.device:
            raise ValueError("data_t and clusters must share one device")


def conditional_counts_t(data_t: torch.Tensor,
                         clusters: torch.Tensor | None, n_clusters: int):
    """data_t: (cols, N) uint8 symbols; clusters: (N,) uint8 ids below
    n_clusters, or None for one cluster.

    Returns int64 tensors on data_t's device: counts0 (C, 72) and cond
    (C, cols-1, 72, 72), cond[cl, c-1, prev, cur]. CPU tensors take the
    plain version; CUDA tensors launch K3 (csrc/hist.cu) in the shape of
    ``card_hist_shape`` or raise. K3 counts no read whose id is at or
    past n_clusters."""
    _check(data_t, clusters, n_clusters)
    if data_t.device.type == "cpu":
        return conditional_counts_reference(data_t, clusters, n_clusters)
    if data_t.device.type != "cuda":
        raise ValueError(f"unsupported device {data_t.device}")
    lib = _build.load()
    A = ALPHABET_SIZE
    data_t = data_t.contiguous()
    cols, n = data_t.shape
    pairs = max(cols - 1, 0)
    counts0 = torch.zeros((n_clusters, A), dtype=torch.long,
                          device=data_t.device)
    cond = torch.zeros((n_clusters, pairs, A, A), dtype=torch.long,
                       device=data_t.device)
    if n == 0 or cols == 0:
        return counts0, cond
    shape = card_hist_shape(data_t, n_clusters)
    cl = clusters.contiguous() if clusters is not None else None
    rc = lib.qvz_hist(data_t.data_ptr(),
                      cl.data_ptr() if cl is not None else None, n, cols,
                      n_clusters, shape["mode"], shape["band"],
                      shape["slice"], shape["nslices"], shape["threads"],
                      shape["smem"], counts0.data_ptr(), cond.data_ptr(),
                      torch.cuda.current_stream(data_t.device).cuda_stream)
    _build.check(rc, "histogram kernel")
    _build.LAUNCHES["hist"] += 1
    return counts0, cond


def conditional_counts(data: torch.Tensor, clusters: torch.Tensor | None,
                       n_clusters: int):
    """As ``conditional_counts_t`` for (N, cols) uint8 symbols."""
    return conditional_counts_t(data.t().contiguous(), clusters, n_clusters)
