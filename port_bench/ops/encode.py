"""A file's encode: ``qvz_tpu_torch.api.compress_bytes(text)`` to the
container's bytes, as ``python -m qvz_tpu_torch -f R -c K -T T --shards
S`` makes them, with the run's WELL seed. The check works out the
whole container but the payloads of the lanes it does not draw: at the
lane count of a large file (8,192 lanes) the reference's serial coder
could not code every lane within a run's time."""

from __future__ import annotations

import numpy as np

CHECKED_LANES = 64
# the configuration's settings this operation acts on; mode and
# distortion have the one value that the call below and the reference
# implement (the program's defaults); warmup_lines reaches the program
# as QVZ_TPU_WARMUP_LINES (run.py)
CONFIG_KEYS = {"mode", "ratio", "distortion", "clusters", "cluster_threshold",
               "shards", "prime", "warmup_lines"}
FIXED = {"mode": "ratio", "distortion": "mse"}
TRAFFIC_KEYS: set = set()


def _kwargs(cfg: dict, seed: bytes, device: str) -> dict:
    return dict(ratio=cfg["ratio"], clusters=cfg["clusters"],
                cluster_threshold=cfg["cluster_threshold"],
                shards=cfg["shards"], prime=cfg["prime"], well_seed=seed,
                device=device)


def prepare(texts: list, cfg: dict, seed: bytes, device: str) -> list:
    return texts


def run(item, cfg: dict, seed: bytes, device: str):
    """(container, the program's phase seconds, the work done: lines,
    columns, payload bytes, text bytes)."""
    from qvz_tpu_torch import api
    blob, stats = api.compress_bytes(item, **_kwargs(cfg, seed, device))
    work = dict(lines=stats.lines, columns=stats.columns,
                payload_bytes=stats.payload_bytes, text_bytes=len(item))
    return blob, dict(stats.phase_seconds), work


def qvz2_config(cfg: dict):
    from port_bench.reference import qvz2
    return qvz2.Config(cfg["clusters"], cfg["ratio"],
                       cfg["cluster_threshold"], cfg["shards"],
                       cfg["prime"], cfg["warmup_lines"])


def checked_shards(n: int, cfg: dict, pick: int) -> list:
    """The shards whose payloads a run checks: the warmup shard, the
    first and the last lane, and CHECKED_LANES lanes drawn from `pick`
    (every shard of a small file)."""
    from port_bench.reference import qvz2
    counts, primed = qvz2.plan(n, qvz2_config(cfg))
    lanes = np.arange(1 if primed else 0, len(counts))
    if len(lanes) <= CHECKED_LANES + 2:
        return list(range(len(counts)))
    rng = np.random.default_rng([pick, 1])
    drawn = rng.choice(lanes[1:-1], CHECKED_LANES, replace=False)
    keep = {int(lanes[0]), int(lanes[-1]), *map(int, drawn)}
    return sorted(keep | ({0} if primed else set()))


def expected(text: bytes, cfg: dict, seed: bytes, pick: int,
             dtype=np.float64, workers: int = 0, log=None):
    """The reference's View of the container of one text: every byte of
    it but the lengths and checksums of the lanes not drawn, whose
    payloads it does not work out (``checked_shards``)."""
    from port_bench.reference import qvz2
    data = qvz2.parse_text(text)
    return qvz2.check_view(
        data, qvz2_config(cfg), np.frombuffer(seed, dtype="<u4"),
        checked_shards(len(data), cfg, pick), dtype, workers, log)


def compare(outputs: list, want) -> dict:
    """The bytes of the reference's View that each output, a container
    or a View, does not hold alike, the most over the outputs; the limit
    is 0: the container is exact."""
    from port_bench.reference import qvz2
    worst = 0
    for out in outputs:
        got = (qvz2.read_view(out, len(want.head))
               if isinstance(out, bytes) else out)
        worst = max(worst, qvz2.bytes_off(got, want))
    return {"checked_bytes_off": (worst, 0)}
