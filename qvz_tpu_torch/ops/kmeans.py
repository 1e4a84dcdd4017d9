"""k-means read clustering on the device (reference: src/cluster.c).

The cluster id of every read is arithmetic-coded into the stream, so the
clustering must be exact: integer squared-L2 distances, the first
minimum wins, integer sums and integer-division means, and the stop rule
of cluster.c:212-243. Counterpart of ``qvz_tpu.ops.kmeans``; the CUDA
kernel K4 (``csrc/kmeans.cu``) replaces
``qvz_tpu.ops.pallas_kernels._kmeans_kernel``. One Lloyd step runs on the
device; the convergence loop runs on the host, as in qvz_tpu, with one
upload of the packed means and one copy back of the packed sums and
counts a step.
"""

from __future__ import annotations

import numpy as np
import torch

from qvz_tpu_torch import _build
from qvz_tpu_torch.constants import MAX_KMEANS_ITERATIONS
from qvz_tpu_torch.device import resolve
from qvz_tpu_torch.spec import kmeans as spec_kmeans

THREADS = 256        # csrc/kmeans.cu kThreads
READS = 4            # reads a thread in the distance pass (kReads)
ROW_PAD = 16         # a tile row's stride is T + ROW_PAD bytes (kRowPad)
TILES = (1024, 512, 256, 128, 64, 32, 16)   # reads a tile, largest first
MAX_READS_PER_BLOCK = 1 << 23   # u32 accumulators: 2^23 * 255 < 2^32
SMEM_RESERVED = 1024            # shared memory the card keeps for a block


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
    if means.shape[0] > 255:
        raise ValueError("at most 255 clusters (uint8 cluster ids)")
    if data_t.shape[0] * 255 ** 2 >= 2 ** 31:
        raise ValueError("too many columns for int32 distances")


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def layout_bytes(T: int, cols: int, k: int, k_pad: int, kt: int, mode: int,
                 means_shared: bool) -> int:
    """Shared memory of one K4 block (csrc/kmeans.cu, Layout): two tiles
    of cols4 rows of T + ROW_PAD bytes, the packed means if shared, the
    tile's masks (mode 0, KT x T/4 words) or assignments (T bytes), and in
    mode 1 the block's (k, cols + 1) u32 sums and counts."""
    cols4 = _round(cols, 4)
    marks = 2 * cols4 * (T + ROW_PAD) \
        + _round(cols4 * k_pad if means_shared else 0, 16)
    sums = marks + _round(kt * T if mode == 0 else T, 16)
    return sums + (k * (cols + 1) * 4 if mode == 1 else 0)


def step_shape(n: int, cols: int, k: int, smem_block: int, smem_sm: int,
               sms: int) -> dict:
    """K4's launch shape for n reads of `cols` columns and k means on a
    card of `sms` SMs with smem_block bytes of shared memory a block and
    smem_sm an SM.

    kt: the means a thread's distances hold at once (4 or 8), k_pad: k
    rounded up to it. mode: where the sums gather, the first that holds:
    0 in registers (k <= 8, one thread a column, so cols <= THREADS), 1 in
    shared memory, 2 in device memory; means_shared: the packed means in
    shared memory where they fit. T: among the tiles of TILES whose
    layout puts two blocks on an SM (all that fit where none does), the
    largest that still gives every SM two tiles, else the smallest. The
    grid walks the ceil(n / T) tiles with at most the blocks the card
    holds, and at least enough that no block owns more than
    MAX_READS_PER_BLOCK reads."""
    kt = 4 if k <= 4 else 8
    k_pad = _round(k, kt)
    modes = ([0] if k <= 8 and cols <= THREADS else []) + [1, 2]
    for mode in modes:
        for means_shared in (True, False):
            fits = []
            for T in TILES:
                b = layout_bytes(T, cols, k, k_pad, kt, mode, means_shared)
                if b <= smem_block:
                    fits.append((T, b, min(2048 // THREADS,
                                           smem_sm // (b + SMEM_RESERVED))))
            if fits:
                fits = [f for f in fits if f[2] >= 2] or fits
                T, b, per_sm = next(
                    (f for f in fits if -(-n // f[0]) >= 2 * sms), fits[-1])
                tiles = -(-n // T)
                grid = min(tiles, per_sm * sms)
                grid = max(grid, -(-tiles // (MAX_READS_PER_BLOCK // T)))
                return {"kt": kt, "k_pad": k_pad, "mode": mode,
                        "means_shared": means_shared, "T": T, "smem": b,
                        "blocks_per_sm": per_sm, "grid": grid,
                        "tiles": tiles}
    raise ValueError(f"no K4 layout for {cols} columns and {k} means in "
                     f"{smem_block} B of shared memory")


def pack_means(means: torch.Tensor, k_pad: int) -> torch.Tensor:
    """The means (K, cols) in 0..255 as K4 reads them: (cols4 / 4, k_pad)
    int32, word (g, j) holding columns 4g..4g+3 of mean j in its bytes,
    lowest first; the padding columns and means are 0."""
    k, cols = means.shape
    cols4 = _round(cols, 4)
    m = torch.zeros((k_pad, cols4), dtype=torch.long, device=means.device)
    m[:k, :cols] = means.long()
    m = m.view(k_pad, cols4 // 4, 4)
    w = m[..., 0] | m[..., 1] << 8 | m[..., 2] << 16 | m[..., 3] << 24
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
    return w.t().to(torch.int32).contiguous()


def card_step_shape(data_t: torch.Tensor, k: int) -> dict:
    """``step_shape`` for the (cols, N) reads `data_t` and k means on the
    current card."""
    block, sm = _build.smem_limits()
    cols, n = data_t.shape
    return step_shape(n, cols, k, block, sm, torch.cuda.get_device_properties(
        data_t.device).multi_processor_count)


def launch(data_t: torch.Tensor, means4: torch.Tensor, k: int, shape: dict):
    """K4 on the card: data_t (cols, N) uint8 and means4 (``pack_means``)
    on one CUDA device, in `shape` (``step_shape``). Returns assign (N,)
    int32 and (k, cols + 1) int64, the sums and, last, the counts."""
    if data_t.device.type != "cuda" or not data_t.is_contiguous() \
            or means4.device != data_t.device or not means4.is_contiguous() \
            or means4.dtype != torch.int32 \
            or means4.shape != (-(-data_t.shape[0] // 4), shape["k_pad"]):
        raise ValueError("K4 takes contiguous (cols, N) reads and packed "
                         "means on one CUDA device")
    lib = _build.load()
    dev = data_t.device
    cols, n = data_t.shape
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.zeros((k, cols + 1), dtype=torch.long, device=dev)
    _build.launch(
        "kmeans", "k-means kernel", dev, lib.qvz_kmeans_step,
        data_t.data_ptr(), n, cols, means4.data_ptr(), k, shape["k_pad"],
        shape["kt"], shape["mode"], int(shape["means_shared"]), shape["T"],
        shape["smem"], shape["grid"], assign.data_ptr(), out.data_ptr())
    return assign, out


def _step_packed(data_t: torch.Tensor, means: torch.Tensor, shape=None):
    """One Lloyd step: (assign (N,) int32, (K, cols + 1) int64 with the
    sums in the first cols columns and the counts in the last). CPU
    tensors take the plain version; CUDA tensors launch K4 in `shape`
    (``step_shape`` on this card where None), the means packed on the
    host and uploaded in one copy, or raise."""
    dev = data_t.device
    if dev.type == "cpu":
        assign, sums, counts = kmeans_step_reference(data_t, means)
        return assign, torch.cat([sums, counts[:, None]], 1)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    data_t = data_t.contiguous()
    k = means.shape[0]
    if shape is None:
        shape = card_step_shape(data_t, k)
    means4 = pack_means(means.cpu(), shape["k_pad"]).to(dev)
    return launch(data_t, means4, k, shape)


def kmeans_step(data_t: torch.Tensor, means: torch.Tensor):
    """One Lloyd step (the contract of
    ``qvz_tpu.ops.pallas_kernels.kmeans_step_fused`` without its row
    padding). data_t: (cols, N) uint8 reads; means: (K, cols) integers in
    0..255 on the same device.

    Returns assign (N,) int32, the first nearest mean of each read; sums
    (K, cols) int64, the symbol sums of each cluster's reads; counts (K,)
    int64, the cluster sizes (both views of one (K, cols + 1) tensor).
    CPU tensors take the plain version; CUDA tensors launch K4
    (csrc/kmeans.cu) or raise."""
    _check(data_t, means)
    if data_t.device.type == "cpu":
        return kmeans_step_reference(data_t, means)
    assign, out = _step_packed(data_t, means)
    return assign, out[:, :-1], out[:, -1]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """The step's one device-to-host copy."""
    return t.cpu().numpy()


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
    assigns, means, iters = lloyd(data, n_clusters, threshold, [data_t],
                                  rand, verbose)
    return assigns[0], means, iters


def lloyd(data: np.ndarray, n_clusters: int, threshold: float,
          blocks: list, rand=None, verbose: bool = False):
    """The k-means of ``kmeans_cluster`` over the reads `data` held on
    the devices as `blocks`, the (cols, n_b) uint8 reads of contiguous
    rows in order, each on its own device (several may share one): each
    Lloyd step runs K4 on every block, with one upload of the packed means
    and one copy back of the packed sums and counts a block, and sums
    the exact integer accumulators on the host. Returns (assign per block,
    (n_b,) uint8 tensors on its device; means (K, cols) uint8 numpy;
    iters)."""
    cols = data.shape[1]
    means = spec_kmeans.seed_centroids(data, n_clusters, rand,
                                       verbose=verbose).astype(np.int64)
    shapes = [card_step_shape(b, n_clusters) if b.device.type == "cuda"
              else None for b in blocks]
    steps = []
    iters = 0
    while iters < MAX_KMEANS_ITERATIONS:
        steps = [_step_packed(b, torch.from_numpy(means), shape)
                 for b, shape in zip(blocks, shapes)]
        iters += 1
        packed = sum(_to_host(p) for _, p in steps)
        means, stop = spec_kmeans.update_means(
            means, packed[:, :cols], packed[:, cols], threshold, verbose)
        if stop:
            break
    if verbose:
        spec_kmeans.verbose_total(iters)
    return ([a.to(torch.uint8) for a, _ in steps], means.astype(np.uint8),
            iters)
