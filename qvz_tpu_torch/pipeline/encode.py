"""The device QVZ2 encode (counterpart of ``qvz_tpu.pipeline.encode``).

Phases, with the JAX package's names in ``EncodeStats.phase_seconds``:

  h2d          the (N, cols) uint8 matrix and the dither draws to the
               device, and its (cols, N) transpose there
  cluster      k-means on the device (ops/kmeans.py, K4) for -c K > 1; the
               convergence loop on the host
  stats        conditional statistics on the device (ops/stats.py, K3)
  design       codebook design on the host (C++ runtime, exact doubles)
  draws        WELL jump-ahead and dither draws on the host
  quantize     K1 on the device (ops/quantize.py)
  device_code  the cluster-id triples (host replay), K2a and K2b on the
               device (ops/coder_device.py), the warmup shard coded by a
               host thread meanwhile, and the payload d2h
  d2h          the device-to-host copies of payload words and recon
  code         everything after quantize: lane coding, host re-coding of
               flagged lanes, distortion and container assembly

Device phases end in a synchronise, so each time covers its device work.
The container is byte-identical to ``qvz_tpu``'s, and to the port's host
engine (``pipeline/host.py``), for the same shard count, priming and WELL
seed. With shards == 1 the statistics and k-means still run on the
device and the host engine codes the single-stream v1 container after
the design, as ``qvz_tpu``'s device path does.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from qvz_tpu_torch.constants import MODE_RATIO
from qvz_tpu_torch.device import resolve, synchronize
from qvz_tpu_torch.format import container_v2
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops import coder_device, kmeans, quantize
from qvz_tpu_torch.ops import stats as dev_stats
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline import host
from qvz_tpu_torch.pipeline.host import (EncodeOutput, EncodeStats,
                                         _shard_draws, shard_plan)


def device_lane_count(n: int) -> int:
    """The shard count that ``--shards 0`` picks for the device coder
    (the formula of ``qvz_tpu.pipeline.encode.encode``), so containers of
    the two packages compare."""
    return max(16, min(8192, max(n // 256, -(-n // 1536))))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to qvz_tpu_torch yet (ROADMAP.md, "
        f"'Modules to port' {item})")


def encode(data: np.ndarray, dist_matrix: np.ndarray, *,
           n_clusters: int = 1, mode: int = MODE_RATIO, ratio: float = 0.5,
           cluster_threshold: float = 4.0,
           well_state: WellState | None = None,
           shards: int = 0,
           reuse_blocks: bytes | None = None,
           want_recon: bool = True,
           prime: bool = True,
           verbose: bool = False,
           device: str | torch.device = "cuda") -> EncodeOutput:
    """Encode (N, cols) uint8 symbols into a QVZ2 container on `device`.

    n_clusters > 1 clusters the reads with k-means first (threshold
    cluster_threshold, -T). shards=0 picks the device lane count;
    shards >= 2 pins it; shards == 1 codes the single-stream v1
    container on the host engine after the device statistics. prime:
    shards after the warmup shard start from its model bank. Outside
    this slice (raises NotImplementedError): reuse_blocks."""
    if reuse_blocks is not None:
        raise _not_ported("--reuse-books", "item 10")
    dev = resolve(device)
    n, columns = data.shape
    if shards == 0:
        shards = device_lane_count(n)
    shards = max(1, min(shards, n))
    if well_state is None:
        well_state = WellState.debug()
    st = EncodeStats(lines=n, columns=columns)
    ph, dv = st.phase_seconds, st.device_seconds

    t0 = time.perf_counter()
    data_dev = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    data_t = data_dev.t().contiguous()
    del data_dev
    synchronize(dev)
    t1 = time.perf_counter()
    ph["h2d"] = dv["h2d"] = t1 - t0

    cl_dev = clusters = None
    if n_clusters > 1:
        cl_dev, _, _ = kmeans.kmeans_cluster(
            data, n_clusters, cluster_threshold, verbose=verbose,
            data_t=data_t)
        clusters = cl_dev.cpu().numpy()
        dv["cluster"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    ph["cluster"] = t2 - t1
    if verbose:
        print(f"Clustering took {t2 - t1:.4f} seconds")

    counts0, cond = dev_stats.conditional_counts_t(data_t, cl_dev,
                                                   n_clusters)
    counts0, cond = counts0.cpu().numpy(), cond.cpu().numpy()
    t3 = time.perf_counter()
    ph["stats"] = dv["stats"] = t3 - t2

    design = rt.Design(counts0, cond, mode, ratio, dist_matrix)
    blocks = design.serialized()
    tables = design.tables()
    t4 = time.perf_counter()
    ph["design"] = t4 - t3
    if verbose:
        print(f"Stats and codebook generation took {t4 - t2:.4f} seconds")

    if shards == 1:
        compressed, payload_bytes, recon, dist_sum = host.encode_v1(
            tables, blocks, data, clusters, n_clusters, well_state,
            dist_matrix, want_recon, verbose)
        ph["code"] = time.perf_counter() - t4
        return _output(compressed, payload_bytes, recon, dist_sum,
                       clusters, st)

    counts, states, offs, prime_on = shard_plan(n, columns, shards, prime,
                                                well_state)
    draws = _shard_draws(states, counts, columns)
    t5 = time.perf_counter()
    ph["draws"] = t5 - t4

    draws_t = torch.from_numpy(draws).to(dev).t().contiguous()
    synchronize(dev)
    t6 = time.perf_counter()
    ph["h2d"] += t6 - t5
    dv["h2d"] += t6 - t5

    mid, qs, qv = quantize.quantize_t_device(
        quantize.tables_to_torch(tables, dev), data_t, draws_t, cl_dev)
    del draws_t
    synchronize(dev)
    t7 = time.perf_counter()
    ph["quantize"] = dv["quantize"] = t7 - t6

    payloads, dist_sum, recon = _code_shards(
        tables, data, data_t, clusters, mid, qs, qv, states, counts, offs,
        prime_on, dist_matrix, want_recon, st)

    shard_states = [np.asarray(states[s], dtype="<u4").tobytes()
                    for s in range(len(counts))]
    compressed = container_v2.build(
        blocks, n_clusters, columns, n, counts, shard_states, payloads,
        priming=1 if prime_on else 0)
    ph["code"] = time.perf_counter() - t7
    return _output(compressed, sum(len(p) for p in payloads), recon,
                   dist_sum, clusters, st)


def _output(compressed, payload_bytes, recon, dist_sum, clusters,
            st) -> EncodeOutput:
    n, columns = st.lines, st.columns
    st.payload_bytes = payload_bytes
    st.rate = (payload_bytes * 8.0) / (float(n) * columns)
    st.distortion = dist_sum / n
    return EncodeOutput(compressed, recon,
                        np.zeros(n, dtype=np.uint8) if clusters is None
                        else clusters, st)


def _code_shards(tables, data, data_t, clusters, mid, qs, qv, states,
                 counts, offs, prime_on, dist_matrix, want_recon, st):
    """Entropy-code the shards: the warmup shard on the host in a thread,
    every other shard as one device lane (the counterpart of qvz_tpu's
    _device_coder_encode). clusters: (N,) uint8 ids, or None with one
    cluster. Returns (payloads, distortion sum, recon)."""
    ph, dv = st.phase_seconds, st.device_seconds
    columns = data.shape[1]
    t0 = time.perf_counter()
    first = 1 if prime_on else 0
    bank = None
    warmup_thread = None
    warmup_out: list = [None]
    if prime_on:
        # The primed bank follows from the warmup shard's quantize
        # decisions alone, so its payload is coded in a host thread
        # while the device codes the lanes.
        w_n = int(counts[0])
        w_cl = clusters[:w_n] if clusters is not None else None
        md0, qs0, _, _ = rt.quantize_colmajor(
            tables, np.ascontiguousarray(data[:w_n].T), w_cl, states[0])
        bank = rt.bank_from_stream(tables, md0, qs0, w_cl, w_n)

        def _code_warmup():
            warmup_out[0] = rt.encode_precomputed_colmajor(
                tables, md0, qs0, w_cl, w_n)

        warmup_thread = threading.Thread(target=_code_warmup)
        warmup_thread.start()
    plan = coder_device.LanePlan(tables, bank)
    plan_t = coder_device.plan_to_torch(plan, mid.device)

    lane_counts = counts[first:]
    ctrip = None
    if clusters is not None:
        # the cluster-id segment: the exact host replay of the cluster-id
        # model, one (cum_lo, cum_hi, total) triple per line of a lane
        ctrip = np.zeros((len(lane_counts), max(lane_counts), 3),
                         dtype=np.uint32)
        for w in range(len(lane_counts)):
            lo, hi = int(offs[first + w]), int(offs[first + w + 1])
            ctrip[w, : hi - lo] = rt.replay_model(
                plan.cluster_init_counts, plan.cluster_init_total,
                clusters[lo:hi])
    tim: dict = {}
    try:
        lane_pays, flags = coder_device.encode_lanes_raw(
            plan_t, mid, qs, lane_counts, int(offs[first]), ctrip,
            stats=tim)
    finally:
        if warmup_thread is not None:
            warmup_thread.join()
    t1 = time.perf_counter()
    ph["device_code"] = dv["device_code"] = t1 - t0
    ph["d2h"] = dv["d2h"] = tim["d2h"]
    st.coder_fallback_lanes = int(flags.sum())

    for w in np.flatnonzero(flags):
        lo, hi = int(offs[first + w]), int(offs[first + w + 1])
        lane_pays[w] = rt.encode_precomputed_colmajor(
            tables,
            np.ascontiguousarray(mid[:, lo:hi].cpu().numpy(),
                                 dtype=np.uint32),
            np.ascontiguousarray(qs[:, lo:hi].cpu().numpy(),
                                 dtype=np.uint8),
            clusters[lo:hi] if clusters is not None else None, hi - lo,
            init_bank=bank)

    t2 = time.perf_counter()
    if want_recon:
        recon = qv.to(torch.uint8).cpu().numpy().T.copy()
        ph["d2h"] += time.perf_counter() - t2
        dv["d2h"] = ph["d2h"]
        dist_sum = float(
            dist_matrix[data.reshape(-1), recon.reshape(-1)].sum()
        ) / columns
    else:
        recon = None
        dist_sum = quantize.distortion_device(data_t, qv,
                                              dist_matrix) / columns
    payloads = ([warmup_out[0]] if prime_on else []) + lane_pays
    return payloads, dist_sum, recon
