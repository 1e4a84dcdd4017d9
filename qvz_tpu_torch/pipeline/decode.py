"""The device QVZ2 decode (counterpart of ``qvz_tpu.pipeline.decode``).

Every shard of a column-major QVZ2 container after the warmup shard is
one lane of the device lane decoder (ops/decoder_device.py, K5). Phases,
in seconds, in ``stats["phase_seconds"]`` when the caller passes a dict:

  parse     header, codebook tables and every lane's payload checksum
  draws     the lanes' WELL dither draws on the host
  h2d       draws and payloads to the device, the draws transposed there
  warmup    the wait for the warmup shard, which a host thread decodes
            meanwhile (primed containers): it gives the lanes' bank
  prologue  K5p on the device, fenced: every lane's start state and, at
            -c K > 1, its cluster-id prologue (the ids K5 reads); in the
            first wave also the decode plan's tables, built once from the
            warmup bank and uploaded
  decoder   K5 on the device, fenced
  d2h       the lanes' text rows and final states to the host
  redecode  the lanes K5p or K5 flagged as corrupt (bad, an id past the
            cluster count, or overrun) decoded again on the host, so that
            its error or output is the outcome

The lanes decode in waves (``_waves``): runs of shards whose draws and
text fit WAVE_BYTES, one K5 call a wave, so host and device memory stay
bounded for any file; each phase's seconds add up over the waves. K5
writes each wave's text rows, symbols + 33 and the newline, straight into
a device buffer, so the rows need no assembly on the host. ``stats`` also
gets ``lanes``, ``waves`` and ``fallback_lanes``: the lanes K5p or K5
flagged, decoded again on the host. K5 takes every plan
(``launch_shape``'s layouts) and K5p and K5 decode every rescale, so only
a corrupt lane goes to the host. Each phase is a ``utils.spans.span``.

v1 containers, row-major QVZ2 and single-shard QVZ2 have no lanes: they
go to the port's host decoder (``pipeline/host.py``), as ``qvz_tpu``
routes them. The output is the host decoder's bytes in every case.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from qvz_tpu_torch.device import resolve, synchronize
from qvz_tpu_torch.format import container, container_v2
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops import coder_device, decoder_device
from qvz_tpu_torch.pipeline import host
from qvz_tpu_torch.pipeline.host import (_malformed_raises_valueerror,
                                         _parsing, _sane_output_size,
                                         _shard_draws)
from qvz_tpu_torch.utils.spans import span

# Host and device bytes of draws and text rows that one wave of lanes
# holds; at 1M x 100 (201 MB) the whole file is one wave.
WAVE_BYTES = 1 << 30


class Lanes(NamedTuple):
    """The inputs of ``decoder_device.decode_lanes_t`` for a container's
    lanes: shards first.. on, as one block of lines."""
    dplan_t: dict
    pays: decoder_device.LanePayloads
    draws_t: torch.Tensor            # (cols, lines of the lanes) uint8
    cl: torch.Tensor | None          # (lines of the lanes,) uint8
    lane_counts: list
    starts: torch.Tensor             # (W, 4) int64
    bank: np.ndarray | None          # the warmup shard's bank, if primed
    first: int                       # the shard of lane 0
    start_flags: torch.Tensor | None = None   # (W,) int64, K5p's flags


def _parse(compressed):
    with _parsing():
        head = container_v2.parse(compressed, blocks_len=None)
        tables = rt.tables_from_blocks(
            compressed[container_v2.header_size():], head.cluster_count,
            head.columns)
        head = container_v2.parse(compressed, blocks_len=tables.consumed)
        _sane_output_size(head.lines, head.columns)
    return head, tables


def _has_lanes(head) -> bool:
    return head.order == container_v2.ORDER_COL and len(head.shards) >= 2


@_malformed_raises_valueerror
def decode(compressed, out: np.ndarray | None = None, verbose: bool = False,
           device: str | torch.device = "cuda",
           stats: dict | None = None) -> np.ndarray:
    """Decode a container to Phred+33 text bytes (lines, cols+1) with
    newlines. `out` may be a preallocated (lines, cols+1) uint8 buffer,
    e.g. an np.memmap, written in place. Column-major QVZ2 lanes decode
    on `device`: "cuda" launches K5 (and raises without a card), "cpu"
    runs its plain version."""
    dev = resolve(device)
    if container_v2.is_v2(compressed):
        head, tables = _parse(compressed)
        if _has_lanes(head):
            if out is None:
                out = np.empty((head.lines, head.columns + 1),
                               dtype=np.uint8)
            _decode_lanes(compressed, head, tables, out, dev,
                          stats if stats is not None else {})
            return out
    return host.decode(compressed, out=out, verbose=verbose)


@_malformed_raises_valueerror
def prepare_lanes(compressed, device: str | torch.device = "cuda") -> Lanes:
    """The K5 inputs of a column-major QVZ2 container with lanes, as
    ``decode`` prepares them."""
    head, tables = _parse(compressed)
    if not _has_lanes(head):
        raise ValueError("the container has no lanes")
    out = np.empty((head.lines, head.columns + 1), dtype=np.uint8)
    warm = _Warmup(compressed, head, tables, out)
    try:
        return _prepare(compressed, head, tables, out, resolve(device), {},
                        range(1 if head.priming else 0, len(head.shards)),
                        warm)
    finally:
        warm.join()


def _payload(compressed, head, i) -> bytes:
    s = head.shards[i]
    pay = bytes(compressed[s.payload_off:s.payload_off + s.payload_len])
    if rt.xxh64(pay) != s.checksum:
        raise ValueError(
            f"shard {i} payload checksum mismatch (corrupt container)")
    return pay


def _well(s) -> np.ndarray:
    return np.frombuffer(s.well_state, dtype="<u4")


def _workers() -> int:
    return min(8, os.cpu_count() or 1)


def _waves(head) -> list[range]:
    """The lanes' shards in runs, each run's draws and text (lines x
    (2 x cols + 1) bytes) within WAVE_BYTES, at least one shard a run."""
    per_line = 2 * head.columns + 1
    waves, start, size = [], 1 if head.priming else 0, 0
    for i in range(start, len(head.shards)):
        b = head.shards[i].lines * per_line
        if i > start and size + b > WAVE_BYTES:
            waves.append(range(start, i))
            start, size = i, 0
        size += b
    waves.append(range(start, len(head.shards)))
    return waves


class _Warmup:
    """The warmup shard's host decode into `out`, in a thread started at
    once (primed containers only): it gives the lanes' bank while the
    first wave's checksums, draws and upload go ahead."""

    def __init__(self, compressed, head, tables, out):
        self._res: dict = {}
        self._thread = None
        if head.priming:
            s0 = head.shards[0]

            def run():
                try:
                    _, self._res["bank"] = rt.decode_colmajor(
                        tables, _payload(compressed, head, 0), s0.lines,
                        _well(s0), out=out[: s0.lines].reshape(-1),
                        want_bank=True)
                except BaseException as e:  # raised again by bank()
                    self._res["err"] = e

            self._thread = threading.Thread(target=run)
            self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()

    def bank(self) -> np.ndarray | None:
        """The lanes' bank (None unprimed), after the wait for it."""
        self.join()
        if "err" in self._res:
            raise self._res["err"]
        return self._res.get("bank")


def _prepare(compressed, head, tables, out, dev, ph, wave: range,
             warm: _Warmup, dplan_t: dict | None = None) -> Lanes:
    """Everything before K5 for the lanes of the shards in `wave`; the
    phases' seconds add up in `ph`. dplan_t is the decode plan's tables on
    `dev`, built here from the warmup bank where None."""
    cols = head.columns
    shards = [head.shards[i] for i in wave]
    with span(ph, "parse"):
        with ThreadPoolExecutor(max_workers=_workers()) as ex:
            pays = list(ex.map(lambda i: _payload(compressed, head, i),
                               wave))

    with span(ph, "draws"):
        lane_counts = [s.lines for s in shards]
        states = np.stack([_well(s) for s in shards])
        draws = _shard_draws(states, lane_counts, cols)

    with span(ph, "h2d"):
        draws_t = torch.from_numpy(draws).to(dev).t().contiguous()
        del draws
        lane_pays = decoder_device.pack_payloads(pays, dev)
        synchronize(dev)
    with span(ph, "warmup"):
        bank = warm.bank()

    with span(ph, "prologue"):
        if dplan_t is None:
            dplan_t = decoder_device.decode_plan_to_torch(
                decoder_device.DecodePlan(
                    coder_device.LanePlan(tables, bank), tables), dev)
        cl, starts, start_flags = decoder_device.cluster_prologue(
            dplan_t, lane_pays, lane_counts)
        synchronize(dev)
    return Lanes(dplan_t, lane_pays, draws_t, cl, lane_counts, starts, bank,
                 wave.start, start_flags)


def _decode_lanes(compressed, head, tables, out, dev, st) -> None:
    """The device branch: the counterpart of qvz_tpu's
    _decode_v2_device, one K5 call a wave of lanes (``_waves``)."""
    ph = st["phase_seconds"] = {}
    shards = head.shards
    offs = np.concatenate([[0], np.cumsum([s.lines for s in shards])]
                          ).astype(np.int64)
    waves = _waves(head)
    host_shards = []                     # the corrupt lanes' shards
    dplan_t = None                       # the same for every wave
    warm = _Warmup(compressed, head, tables, out)
    try:
        for wave in waves:
            lanes = _prepare(compressed, head, tables, out, dev, ph, wave,
                             warm, dplan_t)
            dplan_t = lanes.dplan_t
            with span(ph, "decoder"):
                rows = torch.from_numpy(
                    out[offs[wave.start]:offs[wave.stop]])
                dst = rows if dev.type == "cpu" else torch.empty(
                    rows.shape, dtype=torch.uint8, device=dev)
                final = decoder_device.decode_lanes_t(
                    lanes.dplan_t, lanes.pays, lanes.draws_t, lanes.cl,
                    lanes.lane_counts, 0, lanes.starts, dst, sym_add=33,
                    start_flags=lanes.start_flags)
                synchronize(dev)

            with span(ph, "d2h"):
                if dst is not rows:
                    rows.copy_(dst)
                flags = final[:, 4].cpu().numpy() != 0
                host_shards.extend(wave.start + np.flatnonzero(flags))
            del lanes, dst, final
        bank = warm.bank()
    finally:
        warm.join()

    def redecode(i):
        rt.decode_colmajor(tables, _payload(compressed, head, i),
                           shards[i].lines, _well(shards[i]),
                           out=out[offs[i]:offs[i + 1]].reshape(-1),
                           init_bank=bank)

    with span(ph, "redecode"):
        with ThreadPoolExecutor(max_workers=_workers()) as ex:
            list(ex.map(redecode, host_shards))
    st["lanes"] = len(shards) - (1 if head.priming else 0)
    st["waves"] = len(waves)
    st["fallback_lanes"] = len(host_shards)


@_malformed_raises_valueerror
def decode_to_file(compressed, path: str, verbose: bool = False,
                   device: str | torch.device = "cuda") -> int:
    """Decode straight into a memory-mapped output file. `compressed` may
    be bytes or any buffer (e.g. an np.memmap of the container). Returns
    the number of lines."""
    resolve(device)
    with _parsing():
        if container_v2.is_v2(compressed):
            head = container_v2.parse(compressed, blocks_len=None)
            lines, cols = head.lines, head.columns
        else:
            _, cols, lines = container.read_header(bytes(compressed[:9]))
    if lines == 0:
        open(path, "wb").close()
        return 0
    _sane_output_size(lines, cols)
    mm = np.memmap(path, dtype=np.uint8, mode="w+", shape=(lines, cols + 1))
    decode(compressed, out=mm, verbose=verbose, device=device)
    mm.flush()
    return lines


def decode_file_to_file(in_path: str, out_path: str, verbose: bool = False,
                        device: str | torch.device = "cuda") -> int:
    """Decode a container file, memory-mapped rather than read, into a
    file. Returns the number of lines."""
    if os.path.getsize(in_path) == 0:
        raise ValueError("empty container")
    mm_in = np.memmap(in_path, dtype=np.uint8, mode="r")
    return decode_to_file(mm_in, out_path, verbose=verbose, device=device)
