"""The host parts of the reference's k-means (src/cluster.c), copied from
``qvz_tpu.spec.kmeans``: the centroid seeds and the -v prints. The
per-read cluster id is arithmetic-coded into the bitstream, so the seeds
must be the reference's: unseeded libc rand() -- on glibc a deterministic
seed-1 stream (cluster.c:192-206) -- with reads addressed as (block,
line) in 1M-line blocks (lines.h:12).
"""

from __future__ import annotations

import numpy as np

from qvz_tpu_torch.constants import MAX_LINES_PER_BLOCK
from qvz_tpu_torch.utils.glibc_rand import GlibcRand


def seed_rows(n: int, n_clusters: int, rand: GlibcRand | None = None,
              verbose: bool = False) -> list[int]:
    """The reads whose rows seed the centroids, drawn exactly like the
    reference (cluster.c:192) from n reads. verbose mirrors the
    reference's seed print (cluster.c:202-204)."""
    if rand is None:
        rand = GlibcRand(1)
    block_count = -(-n // MAX_LINES_PER_BLOCK)
    rows = []
    for _ in range(n_clusters):
        block_id = rand.rand() % block_count
        count = min(MAX_LINES_PER_BLOCK, n - block_id * MAX_LINES_PER_BLOCK)
        line_id = rand.rand() % count
        if verbose:
            print(f"Chose block {block_id}, line {line_id}.")
        rows.append(block_id * MAX_LINES_PER_BLOCK + line_id)
    return rows


def seed_centroids(data: np.ndarray, n_clusters: int,
                   rand: GlibcRand | None = None,
                   verbose: bool = False) -> np.ndarray:
    """The initial centroids, the rows of ``seed_rows``."""
    return data[seed_rows(data.shape[0], n_clusters, rand, verbose)]


def update_means(means: np.ndarray, sums: np.ndarray, counts: np.ndarray,
                 threshold: float, verbose: bool = False):
    """One Lloyd update as the reference makes it (cluster.c:212-243):
    the integer means sums // max(count, 1), and whether the largest
    squared movement of a mean is at most threshold (the stop). Returns
    (new means int64, stop)."""
    new_means = sums // np.maximum(counts, 1)[:, None]
    diff = (new_means - means).astype(np.float64)
    moved = float((diff * diff).sum(axis=1).max())
    if verbose:
        verbose_iteration(means, new_means)
    return new_means, moved <= threshold


def verbose_iteration(means_before: np.ndarray,
                      means_after: np.ndarray) -> None:
    """Reference `-v` k-means prints (cluster.c:125-127 prints each
    cluster's squared movement inside recalculate_means, cluster.c:236-238
    a blank line per iteration): mirrored exactly so verbose stdout
    matches the reference. Call once per Lloyd iteration with the
    integer centroid matrices before/after."""
    d = means_after.astype(np.float64) - means_before.astype(np.float64)
    for i, moved in enumerate((d * d).sum(axis=1)):
        print(f"Cluster {i} moved {moved:f}.")
    print()


def verbose_total(iters: int) -> None:
    """Reference end-of-clustering print (cluster.c:241-243)."""
    print(f"\nTotal number of iterations: {iters}.")
