"""The quality text a run codes, made on the device from the run's seed.

Reads of an Illumina-like run (the generator of the repository's verify
recipe): a start Phred value uniform in [start_lo, start_hi], then steps
uniform in [step_lo, step_hi] with one more point down every
`drift_every` columns, the running sum clipped to [clip_lo, clip_hi].
Every file of the pool comes from one torch.Generator seeded with the
run's seed, in a few large calls, so the same seed gives the same files.
The WELL seed of an encode (128 bytes) also comes from the run's seed.
"""

from __future__ import annotations

import numpy as np


def make_pool(seed: int, files: int, reads: int, columns: int, gen: dict,
              device: str) -> list:
    """`files` quality texts of reads x (columns + 1) bytes, newline
    ended, as bytes."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    lo, hi = gen["start"]
    s_lo, s_hi = gen["step"]
    c_lo, c_hi = gen["clip"]
    start = torch.randint(lo, hi + 1, (files, reads, 1), generator=g,
                          device=device, dtype=torch.int32)
    steps = torch.randint(s_lo, s_hi + 1, (files, reads, columns - 1),
                          generator=g, device=device, dtype=torch.int32)
    steps -= (torch.arange(columns - 1, device=device, dtype=torch.int32)
              // gen["drift_every"])
    q = torch.cat([start, steps], dim=2).cumsum(dim=2, dtype=torch.int32)
    q = q.clamp_(c_lo, c_hi).to(torch.uint8) + 33
    nl = torch.full((files, reads, 1), 10, dtype=torch.uint8, device=device)
    text = torch.cat([q, nl], dim=2).cpu().numpy()
    return [text[i].tobytes() for i in range(files)]


def well_seed(seed: int) -> bytes:
    """The 128-byte WELL-1024a seed of an encode, from the run's seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, 32, dtype=np.uint64) \
        .astype("<u4").tobytes()
