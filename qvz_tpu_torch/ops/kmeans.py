"""k-means read clustering on the device (reference: src/cluster.c).

The cluster id of every read is arithmetic-coded into the stream, so the
clustering must be exact: integer squared-L2 distances, the first
minimum wins, integer sums and integer-division means, and the stop rule
of cluster.c:212-243. Counterpart of ``qvz_tpu.ops.kmeans``; the CUDA
kernel K4 (``csrc/kmeans.cu``) replaces
``qvz_tpu.ops.pallas_kernels._kmeans_kernel``. One Lloyd step runs on the
device; the convergence loop runs on the host, as in qvz_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from qvz_tpu_torch import _build
from qvz_tpu_torch.constants import MAX_KMEANS_ITERATIONS
from qvz_tpu_torch.device import resolve
from qvz_tpu_torch.spec import kmeans as spec_kmeans

_TILE = 8            # K4 pads the means to a multiple of 8 clusters


def kmeans_step_reference(data_t: torch.Tensor, means: torch.Tensor):
    """Plain PyTorch version of K4: distances per cluster in int64,
    ``torch.argmin`` (the first minimum), ``index_add_`` for the sums and
    ``bincount`` for the counts. Returns ``kmeans_step``'s outputs."""
    x = data_t.long()
    m = means.long()
    k = m.shape[0]
    dist = torch.stack([((x - m[j][:, None]) ** 2).sum(0)
                        for j in range(k)], 1)                    # (N, K)
    assign = torch.argmin(dist, 1)
    sums = torch.zeros(m.shape, dtype=torch.long, device=x.device)
    sums.index_add_(0, assign, x.t())
    counts = torch.bincount(assign, minlength=k)
    return assign.to(torch.int32), sums, counts


def _check(data_t, means):
    if data_t.dtype != torch.uint8 or data_t.dim() != 2:
        raise TypeError("data_t must be (cols, N) uint8")
    if means.dim() != 2 or means.shape[1] != data_t.shape[0] \
            or means.shape[0] < 1 or means.is_floating_point():
        raise ValueError(f"means {tuple(means.shape)} must be (K, "
                         f"{data_t.shape[0]}) integers")
    if means.device != data_t.device:
        raise ValueError("data_t and means must share one device")
    lo, hi = torch.aminmax(means)
    if int(lo) < 0 or int(hi) > 255:
        raise ValueError("means must lie in 0..255")
    if data_t.shape[0] * 255 ** 2 >= 2 ** 31:
        raise ValueError("too many columns for int32 distances")


def kmeans_step(data_t: torch.Tensor, means: torch.Tensor):
    """One Lloyd step (the contract of
    ``qvz_tpu.ops.pallas_kernels.kmeans_step_fused`` without its row
    padding). data_t: (cols, N) uint8 reads; means: (K, cols) integers in
    0..255 on the same device.

    Returns assign (N,) int32, the first nearest mean of each read; sums
    (K, cols) int64, the symbol sums of each cluster's reads; counts (K,)
    int64, the cluster sizes. CPU tensors take the plain version; CUDA
    tensors launch K4 (csrc/kmeans.cu) or raise."""
    _check(data_t, means)
    if data_t.device.type == "cpu":
        return kmeans_step_reference(data_t, means)
    if data_t.device.type != "cuda":
        raise ValueError(f"unsupported device {data_t.device}")
    lib = _build.load()
    dev = data_t.device
    data_t = data_t.contiguous()
    cols, n = data_t.shape
    k = means.shape[0]
    k_pad = -(-k // _TILE) * _TILE
    means_t = torch.zeros((cols, k_pad), dtype=torch.uint8, device=dev)
    means_t[:, :k] = means.t().to(torch.uint8)
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.zeros((k, cols), dtype=torch.long, device=dev)
    counts = torch.zeros(k, dtype=torch.long, device=dev)
    rc = lib.qvz_kmeans_step(
        data_t.data_ptr(), n, cols, means_t.data_ptr(), k, k_pad,
        assign.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "k-means kernel")
    _build.LAUNCHES["kmeans"] += 1
    return assign, sums, counts


def kmeans_cluster(data: np.ndarray, n_clusters: int, threshold: float,
                   rand=None, verbose: bool = False, *,
                   data_t: torch.Tensor | None = None,
                   device: str | torch.device = "cuda"):
    """Reference-exact k-means of the (N, cols) uint8 reads (the contract
    of ``qvz_tpu.ops.kmeans.kmeans_cluster``): seeds from
    ``spec.kmeans.seed_centroids`` (glibc rand()), then Lloyd steps on
    the device until the largest squared movement of a mean is at most
    `threshold`, or MAX_KMEANS_ITERATIONS steps. -v prints as the
    reference does.

    data_t: the reads already on the device as (cols, N) uint8; without
    it they are uploaded to `device` once. Returns (assign, means,
    iters): assign is an (N,) uint8 tensor on the device, the assignment
    of the last step (made with the means before its update, as the
    reference and qvz_tpu return it); means is (K, cols) uint8 numpy."""
    n, cols = data.shape
    if data_t is None:
        data_t = torch.from_numpy(np.ascontiguousarray(data.T)).to(
            resolve(device))
    if n_clusters == 1:
        return (torch.zeros(n, dtype=torch.uint8, device=data_t.device),
                data[:1].copy(), 0)
    means = spec_kmeans.seed_centroids(data, n_clusters, rand,
                                       verbose=verbose).astype(np.int64)
    assign = None
    iters = 0
    while iters < MAX_KMEANS_ITERATIONS:
        assign, sums, counts = kmeans_step(
            data_t, torch.from_numpy(means).to(data_t.device))
        iters += 1
        new_means = sums.cpu().numpy() // np.maximum(
            counts.cpu().numpy(), 1)[:, None]
        diff = (new_means - means).astype(np.float64)
        moved = float((diff * diff).sum(axis=1).max())
        if verbose:
            spec_kmeans.verbose_iteration(means, new_means)
        means = new_means
        if moved <= threshold:
            break
    if verbose:
        spec_kmeans.verbose_total(iters)
    return assign.to(torch.uint8), means.astype(np.uint8), iters
