"""Batched quantization on the device (reference: src/qv_compressor.c:76-136).

Per read and column, in column order: the context of the previous
*quantized* symbol, the WELL-dithered choice between the lo/hi quantizer,
and the chosen quantizer's state index and reconstruction for the raw
symbol. The recursion is sequential in columns and independent across
reads. Counterpart of ``qvz_tpu.ops.quantize``; the CUDA kernel K1
(``csrc/quantize.cu``) replaces the Pallas kernels of
``qvz_tpu.ops.quantize_pallas``.
"""

from __future__ import annotations

import numpy as np
import torch

from qvz_tpu_torch.constants import ALPHABET_SIZE
from qvz_tpu_torch import _build


THREADS = 512          # csrc/quantize.cu kThreads
READS = 4              # adjacent reads a thread (kReads)
BLOCK_READS = THREADS * READS


def tables_to_torch(tables, device, plain: bool | None = None) -> dict:
    """The quantizer tables of an ``rt.Tables`` as tensors on `device`.
    K1's folded forms, which the runtime builds with the tables: ctx2
    (C*cols*72,) int32, the context (0 for an unreachable prev) | the
    pair's qratio << 8; qsv (n_pairs*2*72,) int16, qs | qv << 8;
    pair_bounds (C*cols + 1,) int32, pair_base and n_pairs; max_pairs,
    the most pairs a (cluster, column) has. Where `plain` (by default on
    the CPU, whose wrapper runs the plain version) also the plain
    version's ctxmap (C*cols*72,) int32 (-1 for an unreachable prev),
    pair_base (C*cols,) int32, qratio (n_pairs,) uint8 and qs_map/qv_map
    (n_pairs*2*72,) uint8. The arrays are copied: the tensors do not
    alias the C++-owned storage."""
    def t(a, dtype):
        # one copy, straight into `device` (a clone on the CPU)
        return torch.from_numpy(
            np.asarray(a, dtype=dtype).reshape(-1)).to(device, copy=True)

    pair_base = np.asarray(tables.pair_base).reshape(-1)
    n_pairs = int(tables.n_pairs)
    bounds = np.append(pair_base, n_pairs).astype(np.int32)
    tabs = {
        "columns": int(tables.columns),
        "n_clusters": int(tables.n_clusters),
        "ctx2": t(np.asarray(tables.ctx2).view(np.int32), np.int32),
        "qsv": t(np.asarray(tables.qsv).view(np.int16), np.int16),
        "pair_bounds": t(bounds, np.int32),
        "max_pairs": int(np.diff(bounds).max(initial=1)),
    }
    if plain is None:
        plain = torch.device(device).type == "cpu"
    if plain:
        tabs.update(
            ctxmap=t(tables.ctxmap, np.int32),
            pair_base=t(pair_base, np.int32),
            qratio=t(tables.qratio, np.uint8),
            qs_map=t(tables.qs_map, np.uint8),
            qv_map=t(tables.qv_map, np.uint8))
    return tabs


def quantize_reference(tabs: dict, data_t: torch.Tensor,
                       draws_t: torch.Tensor,
                       cluster_ids: torch.Tensor | None = None):
    """Plain PyTorch version of K1: the column loop of
    ``qvz_tpu.ops.quantize._quantize_device`` with torch indexing.
    Returns (mid, qs, qv), each (cols, N) int32 on the inputs' device."""
    A = ALPHABET_SIZE
    cols, n = data_t.shape
    dev = data_t.device
    x = data_t.long()
    d = draws_t.long()
    cbase = (torch.zeros(n, dtype=torch.long, device=dev)
             if cluster_ids is None else cluster_ids.long() * cols)
    ctxmap = tabs["ctxmap"].long()
    pair_base = tabs["pair_base"].long()
    qratio = tabs["qratio"].long()
    qs_map = tabs["qs_map"].long()
    qv_map = tabs["qv_map"].long()
    mid = torch.empty((cols, n), dtype=torch.int32, device=dev)
    qs = torch.empty_like(mid)
    qv = torch.empty_like(mid)
    prev = torch.zeros(n, dtype=torch.long, device=dev)
    for c in range(cols):
        cc = cbase + c
        p = pair_base[cc] + ctxmap[cc * A + prev]
        pc = 2 * p + (d[c] >= qratio[p]).long()
        f = pc * A + x[c]
        prev = qv_map[f]
        mid[c] = 1 + pc
        qs[c] = qs_map[f]
        qv[c] = prev
    return mid, qs, qv


def _check(tabs, data_t, draws_t, cluster_ids):
    if data_t.dtype != torch.uint8 or draws_t.dtype != torch.uint8:
        raise TypeError("data_t and draws_t must be uint8")
    if data_t.dim() != 2 or draws_t.shape != data_t.shape:
        raise ValueError(f"data_t {tuple(data_t.shape)} and draws_t "
                         f"{tuple(draws_t.shape)} must be one (cols, N) "
                         "shape")
    if data_t.shape[0] != tabs["columns"]:
        raise ValueError(f"{data_t.shape[0]} columns, tables have "
                         f"{tabs['columns']}")
    ts = [data_t, draws_t] + [v for v in tabs.values()
                              if isinstance(v, torch.Tensor)]
    if cluster_ids is not None:
        if cluster_ids.dtype != torch.uint8 \
                or cluster_ids.shape != (data_t.shape[1],):
            raise ValueError("cluster_ids must be (N,) uint8")
        ts.append(cluster_ids)
    if any(t.device != data_t.device for t in ts):
        raise ValueError("inputs and tables must share one device")


def quantize_t_device(tabs: dict, data_t: torch.Tensor,
                      draws_t: torch.Tensor,
                      cluster_ids: torch.Tensor | None = None):
    """(mid, qs, qv), each (cols, N) int32 on the inputs' device: model
    id 1 + 2*pair + choice, quantizer state index and reconstruction.
    The contract of ``qvz_tpu.ops.quantize.quantize_t_device``.

    data_t/draws_t: (cols, N) uint8 raw symbols and 7-bit dither draws;
    cluster_ids: (N,) uint8 or None. CPU tensors take the plain version;
    CUDA tensors launch K1 (csrc/quantize.cu) or raise."""
    _check(tabs, data_t, draws_t, cluster_ids)
    if data_t.device.type == "cpu":
        return quantize_reference(tabs, data_t, draws_t, cluster_ids)
    if data_t.device.type != "cuda":
        raise ValueError(f"unsupported device {data_t.device}")
    lib = _build.load()
    data_t = data_t.contiguous()
    draws_t = draws_t.contiguous()
    cols, n = data_t.shape
    mid = torch.empty((cols, n), dtype=torch.int32, device=data_t.device)
    qs = torch.empty_like(mid)
    qv = torch.empty_like(mid)
    cl = cluster_ids.contiguous() if cluster_ids is not None else None
    _build.launch(
        "quantize", "quantize kernel", data_t.device, lib.qvz_quantize,
        data_t.data_ptr(), draws_t.data_ptr(),
        cl.data_ptr() if cl is not None else None, n, cols,
        tabs["ctx2"].data_ptr(), tabs["pair_bounds"].data_ptr(),
        tabs["qsv"].data_ptr(), mid.data_ptr(), qs.data_ptr(),
        qv.data_ptr())
    return mid, qs, qv


def distortion_device(data_t: torch.Tensor, qv_t: torch.Tensor,
                      dist_matrix: np.ndarray) -> float:
    """Accumulated distortion sum(dist[x, qv]) from the quantize outputs
    on their device: float32 sums per column, float64 over columns (the
    counterpart of ``qvz_tpu.ops.quantize.distortion_device``; agrees
    with the host's double chain to the printed %.4f)."""
    dist = torch.as_tensor(np.asarray(dist_matrix, dtype=np.float32),
                           device=data_t.device)
    flat = dist.reshape(-1)
    parts = [flat[data_t[c].long() * dist.shape[1] + qv_t[c].long()].sum()
             for c in range(data_t.shape[0])]
    return float(torch.stack(parts).double().sum()) if parts else 0.0
