"""The device QVZ2 encode (counterpart of ``qvz_tpu.pipeline.encode``).

Phases, with the JAX package's names in ``EncodeStats.phase_seconds``:

  h2d          the (N, cols) uint8 matrix to the device and its (cols, N)
               transpose there; for blocks off the card also the host's
               dither draws and their transpose
  cluster      k-means on the device (ops/kmeans.py, K4) for -c K > 1; the
               convergence loop on the host
  stats        conditional statistics on the device (ops/stats.py, K3);
               0.0 with reuse_blocks, whose codebooks stand in for the
               statistics and the design
  design       codebook design on the host (C++ runtime, exact doubles),
               or the tables read from reuse_blocks
  draws        the WELL jump-ahead and the dither draws: KJ and KW
               (ops/well_jump.py, ops/well_draws.py) for the blocks on a
               CUDA device, the host's jump and threads for the others
  quantize     K1 on the device (ops/quantize.py)
  device_code  K2s (the cluster-id segment's triples, -c K > 1), K2a and
               K2b on the device (ops/coder_device.py), the warmup shard
               coded by a host thread meanwhile, and the payload d2h
  d2h          the device-to-host copies of payload words and recon
  code         everything after quantize: lane coding, distortion and
               container assembly

and, inside them (all but design_serial for QVZ2 only):

  design_serial  the design's time outside its threaded context sweeps
                 (``rt.Design.stats``), summed over the clusters; none
                 with reuse_blocks
  jump           the GF(2) jump-ahead of the WELL start states: where
                 every block is on a card, KJ on each block's KW streams
                 (``well_draws.stream_offsets``: the lanes and the warmup
                 shard's pieces), their offsets' upload and the shards'
                 states' copy to the host included; where one is not,
                 every shard's on one host thread (``shard_plan``), and
                 KJ on the card blocks' streams; in draws
  fill           KW's launch on each block on a card, its line offsets'
                 upload included, and for the others the threaded dither
                 draws of the block's shards (``_shard_draws``); in draws
  warmup_prep    the warmup shard's quantize and primed bank on the host,
                 before any lane launches; in device_code
  coder_plan     the lane coder's plan on the host (``LanePlan``: the
                 columns' model tables), its upload to each device and
                 its models at risk (``risk_tables``); in device_code
  lanes          from the first K2 launch (K2s, K2a, K2b) to the last
                 lane's raw output on the host, its copy (d2h) included;
                 in device_code
  payload_finish the lanes' payloads assembled from their raw output on
                 the host (``payloads_from_raw``); in device_code
  warmup_wait    the wait for the warmup shard's coder thread after the
                 last lane is fetched; in device_code
  container      the shard states and the container's assembly; in code

Each phase is a ``utils.spans.span``: under a torch profiler also a range
``qvz.<phase>`` on the profiler's clock. ``EncodeStats.counters`` holds
``h2d_bytes``, the bytes copied to the devices (the reads, KJ's word
offsets and KW's line offsets or the host's draws, and the lane plan;
not KJ's table, uploaded once a device and process),
``device_draws``, the draws KW made (the lines of the blocks on a card
x cols; 0 where the host filled every block's), ``device_jumps``, the
start states KJ made (the streams of the blocks on a card; 0 where the
host jumped every block's), the design's
``lloyd_iters`` and ``lloyd_discarded_iters``, and the lane plan's
``coder_models`` (the models of its columns) and ``coder_models_at_risk``
(``risk_tables``' count at the file's longest lane). Device phases,
``jump`` and ``fill`` end in a synchronise, so each time covers its
device work.
Every encode runs its device phases on blocks of reads
(``parallel/sharded.py``): one block on `device`, or with a mesh one
contiguous block a mesh entry, cut at shard boundaries, the k-means and
statistics merged as exact integers and each block's lanes coded on its
own device. The container does not depend on the split.
The container is byte-identical to ``qvz_tpu``'s, and to the port's host
engine (``pipeline/host.py``), for the same shard count, priming and WELL
seed. With shards == 1 the statistics and k-means still run on the
device and the host engine codes the single-stream v1 container after
the design, as ``qvz_tpu``'s device path does.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from qvz_tpu_torch.constants import MODE_RATIO
from qvz_tpu_torch.device import resolve
from qvz_tpu_torch.format import container_v2
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops import coder_device, quantize, well_draws, well_jump
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.parallel import sharded
from qvz_tpu_torch.pipeline import host
from qvz_tpu_torch.pipeline.host import (EncodeOutput, EncodeStats,
                                         _shard_draws, shard_counts,
                                         shard_plan)
from qvz_tpu_torch.utils.spans import span

# the phases that run on the device, transfers included
# (``EncodeStats.device_seconds``)
DEVICE_PHASES = ("h2d", "cluster", "stats", "quantize", "device_code", "d2h")


def device_lane_count(n: int) -> int:
    """The shard count that ``--shards 0`` picks for the device coder
    (the formula of ``qvz_tpu.pipeline.encode.encode``), so containers of
    the two packages compare."""
    return max(16, min(8192, max(n // 256, -(-n // 1536))))


def encode(data: np.ndarray, dist_matrix: np.ndarray, *,
           n_clusters: int = 1, mode: int = MODE_RATIO, ratio: float = 0.5,
           cluster_threshold: float = 4.0,
           well_state: WellState | None = None,
           shards: int = 0,
           mesh=None,
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
    shards after the warmup shard start from its model bank.
    reuse_blocks: the codebook blocks of an earlier container (a
    checkpoint); K4 still clusters, but the statistics and the design
    are skipped (phase stats 0.0) and the tables come from the blocks.
    mesh: a ``parallel.mesh.DeviceMesh`` in place of `device`; the reads
    split into one contiguous block a mesh entry (at shard boundaries,
    block 0 with the warmup shard; evenly for the v1 container) and
    every device phase runs on each block on its device; the container
    is byte-identical to the one-device encode's."""
    n, columns = data.shape
    devices = mesh.devices if mesh is not None else (resolve(device),)
    if shards == 0:
        shards = device_lane_count(n)
    shards = max(1, min(shards, n))
    if well_state is None:
        well_state = WellState.debug()
    st = EncodeStats(lines=n, columns=columns)
    ph = st.phase_seconds
    if shards == 1:
        bounds = sharded.even_bounds(n, len(devices))
    else:
        counts, prime_on = shard_counts(n, columns, shards, prime)
        bounds = sharded.lane_bounds(np.cumsum([0] + counts),
                                     int(prime_on), len(devices))
    # the phases that ran no device work stay out of device_seconds
    on_host = set() if n_clusters > 1 else {"cluster"}

    with span(ph, "h2d"):
        blocks = sharded.upload(devices, data, bounds)
        sharded.synchronize_all(blocks)
    st.counters["h2d_bytes"] = data.nbytes

    clusters = None
    with span(ph, "cluster"):
        if n_clusters > 1:
            sharded.cluster(blocks, data, n_clusters, cluster_threshold,
                            verbose=verbose)
            clusters = np.concatenate([b.clusters.cpu().numpy()
                                       for b in blocks])
    if verbose:
        print(f"Clustering took {ph['cluster']:.4f} seconds")

    if reuse_blocks is not None:
        on_host.add("stats")
        ph["stats"] = 0.0
        with span(ph, "design"):
            tables = rt.tables_from_blocks(reuse_blocks, n_clusters, columns)
            books = reuse_blocks[:tables.consumed]
    else:
        with span(ph, "stats"):
            counts0, cond = sharded.conditional_counts(blocks, n_clusters)
            counts0, cond = counts0.cpu().numpy(), cond.cpu().numpy()
        with span(ph, "design"):
            design = rt.Design(counts0, cond, mode, ratio, dist_matrix)
            books = design.serialized()
            tables = design.tables()
        if verbose:
            print("Stats and codebook generation took "
                  f"{ph['stats'] + ph['design']:.4f} seconds")
        ds = design.stats()
        ph["design_serial"] = ds.pop("serial_s")
        st.counters.update(ds)

    if shards == 1:
        with span(ph, "code"):
            compressed, payload_bytes, recon, dist_sum = host.encode_v1(
                tables, books, data, clusters, n_clusters, well_state,
                dist_matrix, want_recon, verbose)
        return _output(compressed, payload_bytes, recon, dist_sum,
                       clusters, st, on_host)

    # each block's draws: KW's on a card, from start states that KJ makes
    # there; off the card the host jumps and fills the block's shards and
    # they are copied, as for qvz_tpu
    on_card = [b.device.type == "cuda" for b in blocks]
    st.counters["device_draws"] = 0
    st.counters["device_jumps"] = 0
    with span(ph, "draws"):
        with span(ph, "jump"):
            if all(on_card):
                counts, prime_on = shard_counts(n, columns, shards, prime)
            else:
                counts, states, _, prime_on = shard_plan(
                    n, columns, shards, prime, well_state)
            offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            if any(on_card):
                s_words, s_lines, s_first = well_draws.stream_offsets(
                    counts, columns)
                s_offs = np.concatenate([[0], np.cumsum(s_lines)])
                v0 = host._state_words(well_state)
                # each card block's streams, and their start states there:
                # blocks are cut at shard boundaries
                s_range, s_states = [], []
                for b, card in zip(blocks, on_card):
                    t0, t1 = (int(t) for t in np.searchsorted(
                        s_offs, [b.lo, b.hi]))
                    s_range.append((t0, t1))
                    if card:
                        s_states.append(well_jump.states_t(
                            v0, s_words[t0:t1], b.device))
                        st.counters["device_jumps"] += t1 - t0
                        st.counters["h2d_bytes"] += 8 * (t1 - t0)
                    else:
                        s_states.append(None)
                if all(on_card):
                    # every shard's start state to the host, from its first
                    # stream, for the warmup shard's coder and the container
                    states = np.concatenate(
                        [x.cpu().numpy() for x in s_states]
                    ).view(np.uint32)[s_first]
            sharded.synchronize_all(blocks)
        with span(ph, "fill"):
            draws_t = []
            for i, (b, card) in enumerate(zip(blocks, on_card)):
                if card:
                    t0, t1 = s_range[i]
                    draws_t.append(well_draws.draws_t(
                        s_states[i], s_lines[t0:t1], columns))
                    # the streams' line offsets
                    st.counters["h2d_bytes"] += 8 * (t1 - t0 + 1)
                    st.counters["device_draws"] += int(b.hi - b.lo) * columns
                else:
                    s0, s1 = (int(s) for s in np.searchsorted(
                        offs, [b.lo, b.hi]))
                    draws_t.append(_shard_draws(states[s0:s1],
                                                counts[s0:s1], columns))
            sharded.synchronize_all(blocks)

    if not all(on_card):
        with span(ph, "h2d"):
            for i, b in enumerate(blocks):
                if not on_card[i]:
                    st.counters["h2d_bytes"] += draws_t[i].nbytes
                    draws_t[i] = torch.from_numpy(draws_t[i]).to(b.device) \
                        .t().contiguous()
            sharded.synchronize_all(blocks)

    with span(ph, "quantize"):
        quant = sharded.quantize_blocks(blocks, tables, draws_t)
        del draws_t
        sharded.synchronize_all(blocks)

    with span(ph, "code"):
        payloads, dist_sum, recon = _code_shards(
            tables, data, blocks, quant, clusters, states, counts, offs,
            prime_on, dist_matrix, want_recon, st)
        with span(ph, "container"):
            shard_states = [np.asarray(states[s], dtype="<u4").tobytes()
                            for s in range(len(counts))]
            compressed = container_v2.build(
                books, n_clusters, columns, n, counts, shard_states,
                payloads, priming=1 if prime_on else 0)
    return _output(compressed, sum(len(p) for p in payloads), recon,
                   dist_sum, clusters, st, on_host)


def _output(compressed, payload_bytes, recon, dist_sum, clusters,
            st, on_host) -> EncodeOutput:
    n, columns = st.lines, st.columns
    st.device_seconds.update(
        (k, st.phase_seconds[k]) for k in DEVICE_PHASES
        if k in st.phase_seconds and k not in on_host)
    st.payload_bytes = payload_bytes
    st.rate = (payload_bytes * 8.0) / (float(n) * columns)
    st.distortion = dist_sum / n
    return EncodeOutput(compressed, recon,
                        np.zeros(n, dtype=np.uint8) if clusters is None
                        else clusters, st)


def _code_shards(tables, data, blocks, quant, clusters, states, counts,
                 offs, prime_on, dist_matrix, want_recon, st):
    """Entropy-code the shards: the warmup shard on the host in a thread,
    every other shard as one device lane of the block that holds it (the
    counterpart of qvz_tpu's _device_coder_encode). quant: each block's
    (mid, qs, qv); clusters: (N,) uint8 ids on the host, or None with one
    cluster (each block's lanes code its own ids on its device,
    ``b.clusters``).
    Returns (payloads, distortion sum, recon)."""
    ph = st.phase_seconds
    columns = data.shape[1]
    with span(ph, "device_code"):
        payloads = _code_lanes(tables, data, blocks, quant, clusters,
                               states, counts, offs, prime_on, st)

    if want_recon:
        with span(ph, "d2h"):
            recon = np.concatenate([qv.to(torch.uint8).cpu().numpy().T
                                    for _, _, qv in quant])
        dist_sum = float(
            dist_matrix[data.reshape(-1), recon.reshape(-1)].sum()
        ) / columns
    else:
        recon = None
        dist_sum = sum(quantize.distortion_device(b.data_t, qv, dist_matrix)
                       for b, (_, _, qv) in zip(blocks, quant)) / columns
    return payloads, dist_sum, recon


def _code_lanes(tables, data, blocks, quant, clusters, states, counts, offs,
                prime_on, st) -> list:
    """The shards' payloads, the warmup shard's first: its host thread
    runs while the blocks' lanes code on their devices."""
    ph = st.phase_seconds
    first = 1 if prime_on else 0
    bank = None
    warmup_thread = None
    warmup_out: list = [None]
    if prime_on:
        # The primed bank follows from the warmup shard's quantize
        # decisions alone, so its payload is coded in a host thread
        # while the device codes the lanes.
        with span(ph, "warmup_prep"):
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
    lane_counts = counts[first:]
    # each block's lanes w0 .. w1 - 1, from its local line base
    lanes = []
    for b in blocks:
        w0 = max(int(np.searchsorted(offs, b.lo)), first) - first
        w1 = int(np.searchsorted(offs, b.hi)) - first
        lanes.append((w0, w1, int(offs[first + w0]) - b.lo))
    plans: dict = {}
    with span(ph, "coder_plan"):
        plan = coder_device.LanePlan(tables, bank)
        for b, (w0, w1, _) in zip(blocks, lanes):
            if w1 <= w0:
                continue
            if b.device not in plans:
                plans[b.device] = coder_device.plan_to_torch(plan, b.device)
                st.counters["h2d_bytes"] += sum(
                    v.numel() * v.element_size()
                    for v in plans[b.device].values()
                    if isinstance(v, torch.Tensor))
            # the models at risk for the block's longest lane, and their
            # tables on the device, cached in the plan for its launches
            coder_device.risk_tables(plans[b.device],
                                     int(max(lane_counts[w0:w1])))
        st.counters["coder_models"] = len(plan.mtab)
        st.counters["coder_models_at_risk"] = coder_device.risk_tables(
            next(iter(plans.values())), int(max(lane_counts)))["models"]
    lane_pays: list = [None] * len(lane_counts)
    flags = np.zeros(len(lane_counts), dtype=bool)
    try:
        with span(ph, "lanes"):
            # every block's lanes launched before the first is fetched
            raws = [coder_device.code_lanes(
                        plans[b.device], mid, qs, lane_counts[w0:w1], base,
                        b.clusters) if w1 > w0 else None
                    for b, (mid, qs, _), (w0, w1, base)
                    in zip(blocks, quant, lanes)]
            fetched = [None if raw is None
                       else coder_device.wait_and_fetch(raw)
                       for raw in raws]
            del raws
            ph["d2h"] = sum(f[1] for f in fetched if f is not None)
        with span(ph, "payload_finish"):
            for f, (w0, w1, _) in zip(fetched, lanes):
                if f is not None:
                    lane_pays[w0:w1], flags[w0:w1] = \
                        coder_device.payloads_from_raw(*f[0])
    finally:
        if warmup_thread is not None:
            with span(ph, "warmup_wait"):
                warmup_thread.join()
    # qvz_tpu's field: K2 codes every lane, so none goes to the host
    # (payloads_from_raw raises where one could not be coded)
    st.coder_fallback_lanes = int(flags.sum())
    return ([warmup_out[0]] if prime_on else []) + lane_pays
