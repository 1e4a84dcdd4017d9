"""qvz_tpu_torch's QVZ2 encode on binned qualities (the kernels' plain
versions on the CPU) against qvz_tpu: NovaSeq 2x151 reads whose
Q-scores RTA3 bins to 2, 12, 23 and 37, 151 columns wide, at -c 1 and
-c 3 with the device lane count (shards 0), primed; and files of three
or fewer used values, where the design's PMFs and Lloyd-Max quantizers
are most degenerate."""

import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState as JWell
from qvz_tpu.pipeline import encode as host_encode
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host as port_host

DIST = make_matrix(DISTORTION_MSE)
RTA3 = np.array([2, 12, 23, 37])


def bin_to(q: np.ndarray, bins) -> np.ndarray:
    """Each value to its nearest bin, the lower one on a tie."""
    bins = np.asarray(sorted(bins))
    return bins[np.abs(q[..., None].astype(np.int64) - bins).argmin(-1)] \
        .astype(np.uint8)


def novaseq(n: int, seed: int, cols: int = 151) -> np.ndarray:
    """Reads of the benchmark's NovaSeq configuration: a start Phred in
    37..41, steps in -1..1, clipped to 2..41, then binned."""
    rng = np.random.default_rng(seed)
    start = rng.integers(37, 42, (n, 1))
    steps = rng.integers(-1, 2, (n, cols - 1))
    return bin_to(np.clip(np.concatenate([start, steps], 1).cumsum(1),
                          2, 41), RTA3)


def test_binning_takes_the_lower_bin_on_a_tie():
    q = np.array([2, 6, 7, 8, 17, 18, 30, 31, 41])
    assert bin_to(q, RTA3).tolist() == [2, 2, 2, 12, 12, 23, 23, 37, 37]


def _qvz_tpu(data, **kw):
    """qvz_tpu's device path (shards 0 is its lane count there) and its
    host engine at that lane count."""
    dev = host_encode.encode(data, DIST, well_state=JWell.debug(),
                             use_jax=True, want_recon=False, **kw)
    kw["shards"] = port.device_lane_count(len(data))
    host = host_encode.encode(data, DIST, well_state=JWell.debug(),
                              use_jax=False, want_recon=False, **kw)
    return dev.compressed, host.compressed


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_novaseq_binned_151_matches_qvz_tpu(n_clusters):
    """20,000 reads (a 8,192-read warmup shard, then 78 lanes): the
    container byte-equal to both of qvz_tpu's, every lane coded."""
    data = novaseq(20_000, seed=n_clusters)
    assert set(np.unique(data)) == set(RTA3)
    kw = dict(n_clusters=n_clusters, shards=0, prime=True)
    got = port.encode(data, DIST, well_state=WellState.debug(),
                      device="cpu", want_recon=False, **kw)
    dev, host = _qvz_tpu(data, **kw)
    assert got.compressed == dev == host
    assert got.stats.coder_fallback_lanes == 0


@pytest.mark.parametrize("used", [(37,), (23, 37), (2, 23, 37)],
                         ids=["one", "two", "three"])
def test_few_used_values_match_qvz_tpu(monkeypatch, used):
    """Binned to one, two or three values: contexts of a single symbol,
    PMFs of one to three non-zero entries."""
    monkeypatch.setattr(host_encode, "PRIME_WARMUP_LINES", 512)
    monkeypatch.setattr(port_host, "PRIME_WARMUP_LINES", 512)
    data = bin_to(novaseq(1200, seed=len(used)), used)
    assert set(np.unique(data)) == set(used)
    kw = dict(n_clusters=1, shards=0, prime=True)
    got = port.encode(data, DIST, well_state=WellState.debug(),
                      device="cpu", want_recon=False, **kw)
    dev, host = _qvz_tpu(data, **kw)
    assert got.compressed == dev == host
