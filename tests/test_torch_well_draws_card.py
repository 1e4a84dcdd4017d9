"""KW (``csrc/well.cu``) on the card: its draws against its plain version
and the host runtime's ``rt.well_draws7``, at K1's widths and past the
width at which 16 lines of a stream fill a block's shared memory, and the
device encode that uses it, on one card, on three blocks of one card and
on a mesh of a card and the CPU, against the port's host engine and the
SHA-256 of ``qvz_tpu``'s containers (``golden/kw_encode_sha256.json``,
which ``tests/test_torch_well_draws.py`` holds to ``qvz_tpu`` on the
CPU). Every test is marked ``cuda`` and skips without a card. The file
imports neither JAX nor ``qvz_tpu``, so that it also runs on a machine
without them (``python -m pytest --noconftest`` there)."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from qvz_tpu_torch import _build
from qvz_tpu_torch.constants import DISTORTION_MSE
from qvz_tpu_torch.ops import well_draws as wd
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.parallel import sharded
from qvz_tpu_torch.parallel.mesh import make_mesh
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host

DIST = make_matrix(DISTORTION_MSE)

# (lines, columns, shards, prime, warmup lines): as the CPU tests', and
# 1,000 columns (fewer streams a block)
PLANS = [
    (3001, 37, 8, True, 512),
    (1003, 1, 5, False, 512),
    (2051, 100, 16, True, 256),
    (999, 3, 7, False, 512),
    (1300, 100, 9, False, 512),
    (2600, 1, 4, True, 512),
    (700, 1000, 6, False, 512),
]
IDS = [f"{n}x{c}-s{s}-{'prime' if p else 'noprime'}"
       for n, c, s, p, _ in PLANS]

# (columns, lines of each stream) past 16 lines' shared memory: 4-line
# tiles at 14,600 and 20,000 columns, one-line tiles in chunks of columns
# at 60,000 (a multiple of 4) and 60,001; several blocks of streams each
WIDE = [(14600, [5, 9, 0, 13, 4, 7, 6]), (20000, [3, 17, 1, 8, 2, 6, 5]),
        (60000, [2, 0, 3, 1] * 5), (60001, [2, 0, 3, 1] * 5)]

# the encode's plan and the SHA-256 of qvz_tpu's container for each
# (clusters, primed), written from qvz_tpu on the CPU
GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "kw_encode_sha256.json").read_text())
ENCODE = (GOLDEN["lines"], GOLDEN["columns"], GOLDEN["shards"])


def qvz_tpu_sha256(n_clusters: int, prime: bool) -> str:
    key = f"{n_clusters}-{'prime' if prime else 'noprime'}"
    return GOLDEN["sha256"][key]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (KW has no CPU mode)")


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _data(n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", PLANS, ids=IDS)
def test_kernel_matches_plain_and_host(monkeypatch, plan):
    _card()
    n, cols, shards, prime, warmup = plan
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", warmup)
    well = WellState(np.random.default_rng(n).integers(
        0, 2**32, size=32, dtype=np.uint64))
    counts, states, _, _ = host.shard_plan(n, cols, shards, prime, well)
    s_states, s_lines = wd.stream_plan(states, counts, cols)
    words = torch.from_numpy(s_states.view(np.int32))
    before = _build.LAUNCHES["well_draws"]
    got = wd.draws_t(words.cuda(), s_lines, cols)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["well_draws"] == before + 1
    assert got.shape == (cols, n) and got.is_contiguous()
    assert torch.equal(got.cpu(), wd.draws_t_reference(words, s_lines, cols))
    assert np.array_equal(got.cpu().numpy(),
                          host._shard_draws(states, counts, cols).T)
    # the shards uncut: the same draws
    assert torch.equal(
        wd.draws_t(torch.from_numpy(states.view(np.int32)).cuda(), counts,
                   cols), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cols,lines", WIDE, ids=[str(c) for c, _ in WIDE])
def test_kernel_runs_past_sixteen_lines_of_shared_memory(cols, lines):
    """Where one stream's 16 lines pass a block's shared memory, KW stages
    fewer lines, or one line in chunks of columns, and its draws are still
    rt.well_draws7's."""
    _card()
    states = np.random.default_rng(cols).integers(
        0, 2**32, size=(len(lines), 32), dtype=np.uint64).astype(np.uint32)
    got = wd.draws_t(torch.from_numpy(states.view(np.int32)).cuda(), lines,
                     cols)
    torch.cuda.synchronize()
    assert got.shape == (cols, sum(lines))
    assert np.array_equal(got.cpu().numpy(),
                          host._shard_draws(states, lines, cols).T)


@pytest.mark.cuda
@pytest.mark.parametrize("n_clusters", [1, 3])
@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_device_encode_with_kw_matches_host_engine(monkeypatch, n_clusters,
                                                   prime):
    """The device encode's draws come from KW, one launch a block, and its
    container is the host engine's and qvz_tpu's."""
    _card()
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 512)
    n, cols, shards = ENCODE
    data = _data(n, cols, n_clusters)
    kw = dict(n_clusters=n_clusters, shards=shards, prime=prime,
              want_recon=False)
    want = host.encode(data, DIST, **kw)
    assert _sha256(want.compressed) == qvz_tpu_sha256(n_clusters, prime)
    on_cpu = port.encode(data, DIST, device="cpu", **kw).stats.counters
    assert on_cpu["device_draws"] == 0
    counts, states, _, _ = host.shard_plan(n, cols, shards, prime,
                                           WellState.debug())
    streams = len(wd.stream_plan(states, counts, cols)[1])
    for mesh, blocks in ((None, 1), (make_mesh(devices=["cuda:0"] * 3), 3)):
        before = _build.LAUNCHES["well_draws"]
        got = port.encode(data, DIST, mesh=mesh, device="cuda", **kw)
        assert _build.LAUNCHES["well_draws"] == before + blocks
        assert got.compressed == want.compressed
        ct = got.stats.counters
        assert ct["device_draws"] == n * cols
        # KJ's word offsets and KW's line offsets go up in place of the
        # draws (the lane plan once a device, here one card)
        assert ct["h2d_bytes"] == on_cpu["h2d_bytes"] - n * cols \
            + 8 * streams + 8 * (streams + blocks)
        assert all(type(v) is int for v in ct.values()), ct


@pytest.mark.cuda
@pytest.mark.parametrize("n_clusters", [1, 3])
@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_mixed_mesh_makes_each_blocks_draws_on_its_device(monkeypatch,
                                                          n_clusters, prime):
    """On a mesh of a card and the CPU, KW makes the card block's draws,
    one launch, and the host fills the CPU block's; the container is
    qvz_tpu's."""
    _card()
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 512)
    n, cols, shards = ENCODE
    data = _data(n, cols, n_clusters)
    counts, prime_on = host.shard_counts(n, cols, shards, prime)
    (lo, hi), _ = sharded.lane_bounds(np.cumsum([0] + counts),
                                      int(prime_on), 2)
    before = _build.LAUNCHES["well_draws"]
    got = port.encode(data, DIST, mesh=make_mesh(devices=["cuda:0", "cpu"]),
                      n_clusters=n_clusters, shards=shards, prime=prime,
                      want_recon=False)
    assert _build.LAUNCHES["well_draws"] == before + 1
    assert got.stats.counters["device_draws"] == (hi - lo) * cols
    assert 0 < hi - lo < n
    assert _sha256(got.compressed) == qvz_tpu_sha256(n_clusters, prime)


@pytest.mark.cuda
def test_device_encode_of_wide_reads_matches_host_engine():
    """A device encode of reads past 16 lines' shared memory (14,600
    columns, KW's 4-line tiles) still makes its draws on the card, and its
    container is the host engine's."""
    _card()
    n, cols = 18, 14600
    data = _data(n, cols, 5)
    kw = dict(shards=3, prime=False, want_recon=False)
    before = _build.LAUNCHES["well_draws"]
    got = port.encode(data, DIST, device="cuda", **kw)
    assert _build.LAUNCHES["well_draws"] == before + 1
    assert got.stats.counters["device_draws"] == n * cols
    assert got.compressed == host.encode(data, DIST, **kw).compressed
