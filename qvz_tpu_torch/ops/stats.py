"""Conditional statistics on the device (reference: src/codebook.c:185-220).

Counts of (cluster, previous symbol, symbol) for every pair of adjacent
columns, plus the first column's histogram per cluster: the contract of
``qvz_tpu.ops.stats.conditional_counts``. The CUDA kernel K3
(``csrc/hist.cu``) replaces ``qvz_tpu.ops.pallas_kernels._hist_kernel``
and the XLA scan ``qvz_tpu.ops.stats._hist_device``; its plain PyTorch
version is ``conditional_counts_reference`` (``torch.bincount``, exact
integer counts in int64).
"""

from __future__ import annotations

import torch

from qvz_tpu_torch.constants import ALPHABET_SIZE
from qvz_tpu_torch import _build


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
    plain version; CUDA tensors launch K3 (csrc/hist.cu) or raise."""
    _check(data_t, clusters, n_clusters)
    if data_t.device.type == "cpu":
        return conditional_counts_reference(data_t, clusters, n_clusters)
    if data_t.device.type != "cuda":
        raise ValueError(f"unsupported device {data_t.device}")
    lib = _build.load()
    A = ALPHABET_SIZE
    data_t = data_t.contiguous()
    cols, n = data_t.shape
    counts0 = torch.zeros((n_clusters, A), dtype=torch.long,
                          device=data_t.device)
    cond = torch.zeros((n_clusters, max(cols - 1, 0), A, A),
                       dtype=torch.long, device=data_t.device)
    cl = clusters.contiguous() if clusters is not None else None
    rc = lib.qvz_hist(data_t.data_ptr(),
                      cl.data_ptr() if cl is not None else None, n, cols,
                      n_clusters, counts0.data_ptr(), cond.data_ptr(),
                      torch.cuda.current_stream(data_t.device).cuda_stream)
    _build.check(rc, "histogram kernel")
    _build.LAUNCHES["hist"] += 1
    return counts0, cond


def conditional_counts(data: torch.Tensor, clusters: torch.Tensor | None,
                       n_clusters: int):
    """As ``conditional_counts_t`` for (N, cols) uint8 symbols."""
    return conditional_counts_t(data.t().contiguous(), clusters, n_clusters)
