"""k-means read clustering as the C reference makes it (src/cluster.c).

Centroid seeds come from unseeded libc rand() -- on glibc a
deterministic seed-1 stream (cluster.c:192-206) -- with reads addressed
as (block, line) in 1M-line blocks (lines.h:12). Distances are exact
integer squared L2, the first minimum wins, means are integer-division
means of uint64 sums, and a largest squared centroid move at most the
threshold stops the loop (at most 1,000 iterations). Every quantity is
an exact integer, so the float32 products below (all under 2^24, in
blocks of rows) give the reference's numbers.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MAX_ITERATIONS = 1000
LINES_PER_BLOCK = 1_000_000


class GlibcRand:
    """glibc's rand() (TYPE_3 additive feedback), seeded with 1."""

    def __init__(self, seed: int = 1):
        r = [0] * 34
        r[0] = seed
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            r[i] = word + 2147483647 if word < 0 else word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._h = r
        for _ in range(310):
            self._next()

    def _next(self) -> int:
        h = self._h
        v = (h[-3] + h[-31]) & 0xFFFFFFFF
        h.append(v)
        if len(h) > 64:
            del h[:-31]
        return v

    def rand(self) -> int:
        return self._next() >> 1


def seed_rows(n: int, k: int) -> list[int]:
    rand = GlibcRand(1)
    blocks = -(-n // LINES_PER_BLOCK)
    rows = []
    for _ in range(k):
        b = rand.rand() % blocks
        count = min(LINES_PER_BLOCK, n - b * LINES_PER_BLOCK)
        rows.append(b * LINES_PER_BLOCK + rand.rand() % count)
    return rows


# Rows a block: every distance, product and block sum below is an
# integer under 2^24 (100 columns of values under 72, 2^18 rows), so
# float32 arithmetic gives it exactly in any order of summation. The
# products run one after another: BLAS called from several threads at
# once gave wrong sums.
CHUNK = 1 << 18


def _chunks(n: int) -> list:
    return [(lo, min(n, lo + CHUNK)) for lo in range(0, n, CHUNK)]


def cluster(data: np.ndarray, k: int, threshold: float) -> np.ndarray:
    """(N,) uint8 cluster ids of the (N, cols) symbols. A row's own
    squared norm is the same for every mean, so it is left out of the
    argmin."""
    n = data.shape[0]
    if k == 1:
        return np.zeros(n, dtype=np.uint8)
    means = data[seed_rows(n, k)].astype(np.int64)
    x = data.astype(np.float32)
    assign = np.zeros(n, dtype=np.uint8)
    for _ in range(MAX_ITERATIONS):
        m = means.astype(np.float32)
        d = (m * m).sum(axis=1)[None, :] - 2.0 * (x @ m.T)
        assign = np.argmin(d, axis=1).astype(np.uint8)
        counts = np.bincount(assign, minlength=k).astype(np.int64)
        sums = np.zeros((k, data.shape[1]), dtype=np.int64)
        for lo, hi in _chunks(n):
            onehot = np.zeros((hi - lo, k), dtype=np.float32)
            onehot[np.arange(hi - lo), assign[lo:hi]] = 1.0
            sums += np.rint(onehot.T @ x[lo:hi]).astype(np.int64)
        new = sums // np.maximum(counts, 1)[:, None]
        moved = ((new - means).astype(np.float64) ** 2).sum(axis=1).max()
        means = new
        if moved <= threshold:
            break
    return assign


def _block_statistics(data, clusters, k, alphabet):
    cols = data.shape[1]
    a2 = alphabet * alphabet
    cl = clusters.astype(np.int64)
    counts0 = np.bincount(cl * alphabet + data[:, 0],
                          minlength=k * alphabet)
    cond = np.empty((cols - 1, k * a2), dtype=np.int64)
    base = cl * a2
    prev = data[:, 0].astype(np.int64) * alphabet
    for c in range(1, cols):
        cur = data[:, c].astype(np.int64)
        cond[c - 1] = np.bincount(base + prev + cur, minlength=k * a2)
        prev = cur * alphabet
    return counts0, cond


def statistics(data: np.ndarray, clusters: np.ndarray, k: int,
               alphabet: int = 72):
    """Per cluster the column-0 counts (K, A) and the transition counts
    (K, cols - 1, A, A), [cluster, col - 1, previous, current], summed
    over blocks of rows side by side."""
    cols = data.shape[1]
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        parts = list(ex.map(
            lambda c: _block_statistics(data[c[0]:c[1]],
                                        clusters[c[0]:c[1]], k, alphabet),
            _chunks(data.shape[0])))
    counts0 = sum(p[0] for p in parts).reshape(k, alphabet)
    cond = sum(p[1] for p in parts).reshape(cols - 1, k, alphabet, alphabet)
    return counts0.astype(np.int64), np.ascontiguousarray(
        cond.transpose(1, 0, 2, 3))
