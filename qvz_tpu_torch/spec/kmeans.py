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


def seed_centroids(data: np.ndarray, n_clusters: int,
                   rand: GlibcRand | None = None,
                   verbose: bool = False) -> np.ndarray:
    """Pick initial centroids exactly like the reference (cluster.c:192).
    verbose mirrors the reference's seed print (cluster.c:202-204)."""
    if rand is None:
        rand = GlibcRand(1)
    n = data.shape[0]
    block_count = -(-n // MAX_LINES_PER_BLOCK)
    means = np.empty((n_clusters, data.shape[1]), dtype=np.uint8)
    for j in range(n_clusters):
        block_id = rand.rand() % block_count
        count = min(MAX_LINES_PER_BLOCK, n - block_id * MAX_LINES_PER_BLOCK)
        line_id = rand.rand() % count
        if verbose:
            print(f"Chose block {block_id}, line {line_id}.")
        means[j] = data[block_id * MAX_LINES_PER_BLOCK + line_id]
    return means


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
