"""A file's encode of binned qualities: ``ops/encode.py``'s encode of
the pool's text after each quality is mapped to the nearest of the
configuration's `bins`, the lower one on a tie, as a sequencer's
real-time analysis bins its Q-scores (Illumina RTA3: 2, 12, 23, 37).
The generator's random walk is binned here, so ``inputs.make_pool`` is
shared with the other cells; ``expected`` bins the unbinned text that
``run.py`` gives it the same way. The run, the checked lanes and the
comparison are encode's; ``run`` also puts the encode's counters
(``EncodeStats.counters``) into the work."""

from __future__ import annotations

import numpy as np

from port_bench.ops import encode

CONFIG_KEYS = encode.CONFIG_KEYS | {"bins"}
FIXED = encode.FIXED
TRAFFIC_KEYS = encode.TRAFFIC_KEYS
compare = encode.compare

NEWLINE = 10


def bin_table(bins) -> np.ndarray:
    """The byte map of a quality text: each Phred + 33 byte to its
    nearest bin's, the lower bin on a tie; the newline kept."""
    b = np.asarray(sorted(bins), dtype=np.int64)
    phred = np.arange(256, dtype=np.int64)[:, None] - 33
    table = (b[np.abs(phred - b).argmin(1)] + 33).astype(np.uint8)
    table[NEWLINE] = NEWLINE
    return table


def bin_text(text: bytes, bins) -> bytes:
    return bin_table(bins)[np.frombuffer(text, dtype=np.uint8)].tobytes()


def prepare(texts: list, cfg: dict, seed: bytes, device: str) -> list:
    return [bin_text(t, cfg["bins"]) for t in texts]


def run(item, cfg: dict, seed: bytes, device: str):
    """encode's run, with the program's counters in the work."""
    from qvz_tpu_torch import api
    blob, stats = api.compress_bytes(item,
                                     **encode._kwargs(cfg, seed, device))
    work = dict(stats.counters, lines=stats.lines, columns=stats.columns,
                payload_bytes=stats.payload_bytes, text_bytes=len(item))
    return blob, dict(stats.phase_seconds), work


def expected(text: bytes, cfg: dict, seed: bytes, pick: int,
             dtype=np.float64, workers: int = 0, log=None):
    """encode's View of the binned text."""
    return encode.expected(bin_text(text, cfg["bins"]), cfg, seed, pick,
                           dtype, workers, log)
