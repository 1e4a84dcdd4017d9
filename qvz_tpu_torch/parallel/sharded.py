"""The encode's device steps over contiguous blocks of reads, one block a
mesh entry (counterpart of ``qvz_tpu.parallel.sharded``).

``qvz_tpu`` pads the reads to a multiple of the mesh and masks the pad
rows inside ``shard_map``; here every block has its own length, so no
padding or mask exists. Each block's reads, cluster ids and quantizer
outputs stay on its device, and only exact integers cross devices: the
statistics (K3 on each block, the int64 counts summed on the first
block's device) and the k-means accumulators (K4 on each block, the
packed sums and counts summed on the host). So any split gives the
one-device result bit for bit. The codebook tables are copied to each
device once; K1 and the lane coder (K2a, K2b) need no collective.

``pipeline.encode.encode`` runs every encode through these steps, the
one-device encode as a single block; ``sharded_conditional_counts``,
``kmeans_cluster_sharded`` and ``quantize_sharded_t`` are the host API of
``qvz_tpu``'s module, numpy in and out, over an even split of the reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from qvz_tpu_torch.device import synchronize
from qvz_tpu_torch.ops import kmeans, quantize
from qvz_tpu_torch.ops import stats as dev_stats


@dataclass
class Block:
    """Reads lo .. hi - 1 on `device`: data_t (cols, hi - lo) uint8 and,
    after the k-means, clusters (hi - lo,) uint8 (None with one
    cluster)."""

    device: torch.device
    lo: int
    hi: int
    data_t: torch.Tensor
    clusters: torch.Tensor | None = None


def even_bounds(n: int, parts: int) -> list:
    """n reads in at most `parts` contiguous (lo, hi) blocks whose sizes
    differ by at most one; no block is empty."""
    cuts = [i * n // parts for i in range(parts + 1)]
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]


def lane_bounds(offs, first: int, parts: int) -> list:
    """The (lo, hi) reads of at most `parts` blocks cut at shard
    boundaries: the lanes (shards first .. S - 1 of the plan whose line
    offsets are offs, (S + 1,)) in contiguous groups whose sizes differ by
    at most one, block 0 also holding the warmup shard where first is 1;
    no block is empty."""
    lanes = len(offs) - 1 - first
    cuts = [first + g * lanes // parts for g in range(parts + 1)]
    cuts[0] = 0
    return [(int(offs[a]), int(offs[b])) for a, b in zip(cuts, cuts[1:])
            if b > a]


def upload(devices, data: np.ndarray, bounds) -> list:
    """One Block a (lo, hi) of `bounds`, on the device of the same place in
    `devices`: its rows of the (N, cols) uint8 `data` copied there and
    transposed on the device."""
    blocks = []
    for dev, (lo, hi) in zip(devices, bounds):
        rows = torch.from_numpy(np.ascontiguousarray(data[lo:hi])).to(dev)
        blocks.append(Block(dev, lo, hi, rows.t().contiguous()))
    return blocks


def synchronize_all(blocks) -> None:
    for dev in dict.fromkeys(b.device for b in blocks):
        synchronize(dev)


def conditional_counts(blocks, n_clusters: int):
    """K3 on every block and the int64 counts summed on the first block's
    device (``qvz_tpu``'s ``_local_hist`` and ``psum``): (counts0 (C, 72),
    cond (C, cols - 1, 72, 72)) as ``ops.stats.conditional_counts_t``
    gives them for all the reads."""
    home = blocks[0].device
    total = None
    for b in blocks:
        part = [t.to(home) for t in dev_stats.conditional_counts_t(
            b.data_t, b.clusters, n_clusters)]
        total = part if total is None else [x + y
                                            for x, y in zip(total, part)]
    return total


def cluster(blocks, data: np.ndarray, n_clusters: int, threshold: float,
            rand=None, verbose: bool = False):
    """The k-means of ``ops.kmeans.kmeans_cluster`` over the blocks (K4 on
    each block a step, the accumulators summed): sets each block's
    clusters and returns (means (K, cols) uint8, iterations)."""
    assigns, means, iters = kmeans.lloyd(
        data, n_clusters, threshold, [b.data_t for b in blocks], rand,
        verbose)
    for b, a in zip(blocks, assigns):
        b.clusters = a
    return means, iters


def quantize_blocks(blocks, tables, draws_t) -> list:
    """K1 on every block, the tables copied to each device once: (mid, qs,
    qv) per block as ``ops.quantize.quantize_t_device`` gives them.
    draws_t: each block's (cols, hi - lo) uint8 draws on its device."""
    tabs = {}
    out = []
    for b, d in zip(blocks, draws_t):
        if b.device not in tabs:
            tabs[b.device] = quantize.tables_to_torch(tables, b.device)
        out.append(quantize.quantize_t_device(tabs[b.device], b.data_t, d,
                                              b.clusters))
    return out


def _host_blocks(mesh, data: np.ndarray, cluster_ids=None) -> list:
    blocks = upload(mesh.devices, data, even_bounds(len(data), mesh.size))
    if cluster_ids is not None:
        ids = np.asarray(cluster_ids, dtype=np.uint8)
        for b in blocks:
            b.clusters = torch.from_numpy(
                np.ascontiguousarray(ids[b.lo:b.hi])).to(b.device)
    return blocks


def sharded_conditional_counts(mesh, data: np.ndarray, clusters,
                               n_clusters: int):
    """Host API: the statistics of the (N, cols) reads split evenly over
    the mesh; int64 numpy (counts0 (C, 72), cond (C, cols - 1, 72, 72)),
    as ``qvz_tpu.parallel.sharded.sharded_conditional_counts``."""
    c0, cond = conditional_counts(_host_blocks(mesh, data, clusters),
                                  n_clusters)
    return c0.cpu().numpy(), cond.cpu().numpy()


def kmeans_cluster_sharded(mesh, data: np.ndarray, n_clusters: int,
                           threshold: float, rand=None,
                           verbose: bool = False):
    """Host API: k-means of the reads split evenly over the mesh;
    (assign (N,) uint8, means (K, cols) uint8, iterations) as
    ``qvz_tpu.parallel.sharded.kmeans_cluster_sharded``."""
    if n_clusters == 1:
        return np.zeros(len(data), dtype=np.uint8), data[:1].copy(), 0
    blocks = _host_blocks(mesh, data)
    means, iters = cluster(blocks, data, n_clusters, threshold, rand,
                           verbose)
    return (np.concatenate([b.clusters.cpu().numpy() for b in blocks]),
            means, iters)


def quantize_sharded_t(mesh, tables, data: np.ndarray, cluster_ids,
                       draws: np.ndarray):
    """Host API: K1 over the reads split evenly over the mesh; (cols, N)
    numpy (model ids uint32, qs uint8, qv uint8), as
    ``qvz_tpu.parallel.sharded.quantize_sharded_t``."""
    blocks = _host_blocks(mesh, data, cluster_ids)
    draws_t = [torch.from_numpy(np.ascontiguousarray(draws[b.lo:b.hi]))
               .to(b.device).t().contiguous() for b in blocks]
    outs = quantize_blocks(blocks, tables, draws_t)
    return tuple(np.concatenate([o[k].cpu().numpy() for o in outs], axis=1)
                 .astype(dt) for k, dt in enumerate((np.uint32, np.uint8,
                                                     np.uint8)))
