"""KJ (``csrc/well_jump.cu``) on the card: the start states of the
encode's WELL streams against the host runtime's chained ``rt.well_jump``
on the benchmark files' full plans, and the device encode that uses it,
on one card, on three blocks of one card and on a mesh of a card and the
CPU, against the SHA-256 of ``qvz_tpu``'s containers
(``golden/kw_encode_sha256.json``, which ``tests/test_torch_well_draws.py``
holds to ``qvz_tpu`` on the CPU). Every test is marked ``cuda`` and skips
without a card. The file imports neither JAX nor ``qvz_tpu``, so that it
also runs on a machine without them (``python -m pytest --noconftest``
there)."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from qvz_tpu_torch import _build
from qvz_tpu_torch.constants import DISTORTION_MSE
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops import well_draws as wd
from qvz_tpu_torch.ops import well_jump as wj
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.parallel import sharded
from qvz_tpu_torch.parallel.mesh import make_mesh
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host

DIST = make_matrix(DISTORTION_MSE)

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "kw_encode_sha256.json").read_text())
ENCODE = (GOLDEN["lines"], GOLDEN["columns"], GOLDEN["shards"])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (KJ has no CPU mode)")


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _golden(n_clusters: int, prime: bool) -> str:
    key = f"{n_clusters}-{'prime' if prime else 'noprime'}"
    return GOLDEN["sha256"][key]


def _data(n, cols, seed):
    """The reads of tests/test_torch_well_draws_card.py's encodes."""
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cols,streams", [
    (10_000_000, 100, 8224), (7_000_000, 151, 8256)],
    ids=["c3-encode-10m", "nova-encode-7m"])
def test_kernel_matches_host_jump_on_the_benchmark_plans(n, cols, streams):
    """KJ's states of every stream of the benchmark files' plans (--shards
    0, primed, the debug seed and another) equal stream_plan's, which the
    host's chained rt.well_jump makes, and the plain version's on the
    card; one launch."""
    _card()
    for well in (WellState.debug(), WellState(np.random.default_rng(n)
                                              .integers(0, 2**32, size=32,
                                                        dtype=np.uint64))):
        counts, states, _, prime_on = host.shard_plan(
            n, cols, port.device_lane_count(n), True, well)
        assert prime_on
        want, _ = wd.stream_plan(states, counts, cols)
        words, _, first = wd.stream_offsets(counts, cols)
        assert len(words) == streams
        v0 = host._state_words(well)
        before = _build.LAUNCHES["well_jump"]
        got = wj.states_t(v0, words, "cuda")
        torch.cuda.synchronize()
        assert _build.LAUNCHES["well_jump"] == before + 1
        assert got.dtype == torch.int32 and got.shape == (streams, 32)
        got_h = got.cpu().numpy().view(np.uint32)
        assert np.array_equal(got_h, want)
        assert np.array_equal(got_h[first], states)
        plain = wj.states_t_reference(
            torch.from_numpy(v0.view(np.int32)).cuda(),
            torch.from_numpy(words).cuda(), wj.table_t(got.device))
        assert torch.equal(plain, got)


@pytest.mark.cuda
def test_kernel_matches_host_jump_past_2_32_words():
    """Offsets of 0, single bits and past 2^32 words, in a group smaller
    than one block."""
    _card()
    v0 = np.random.default_rng(5).integers(
        0, 2**32, size=32, dtype=np.uint64).astype(np.uint32)
    offsets = np.array([0, 1, 1 << 20, 2**32 + 30_400, 2**40 + 3, 0],
                       dtype=np.int64)
    got = wj.states_t(v0, offsets, "cuda").cpu().numpy().view(np.uint32)
    for o, row in zip(offsets, got):
        want = rt.well_jump(v0, 2, int(o))[1] if o else v0
        assert np.array_equal(row, want), o
    assert wj.states_t(v0, offsets[:0], "cuda").shape == (0, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_clusters", [1, 3])
@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_device_encode_jumps_on_the_card(monkeypatch, n_clusters, prime):
    """The device encode's start states come from KJ, one launch a card
    block, device_jumps the blocks' streams, and its container is
    qvz_tpu's."""
    _card()
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 512)
    n, cols, shards = ENCODE
    data = _data(n, cols, n_clusters)
    counts, _ = host.shard_counts(n, cols, shards, prime)
    streams = len(wd.stream_offsets(counts, cols)[0])
    kw = dict(n_clusters=n_clusters, shards=shards, prime=prime,
              want_recon=False)
    for mesh, blocks in ((None, 1), (make_mesh(devices=["cuda:0"] * 3), 3)):
        before = _build.LAUNCHES["well_jump"]
        got = port.encode(data, DIST, mesh=mesh, device="cuda", **kw)
        assert _build.LAUNCHES["well_jump"] == before + blocks
        assert got.stats.counters["device_jumps"] == streams
        assert _sha256(got.compressed) == _golden(n_clusters, prime)


@pytest.mark.cuda
@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_mixed_mesh_jumps_the_card_blocks_streams(monkeypatch, prime):
    """On a mesh of a card and the CPU, KJ makes the card block's start
    states, one launch, the host jumps every shard for the CPU block and
    the container; device_jumps the card block's streams; the container
    is qvz_tpu's."""
    _card()
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 512)
    n, cols, shards = ENCODE
    data = _data(n, cols, 3)
    counts, prime_on = host.shard_counts(n, cols, shards, prime)
    (lo, hi), _ = sharded.lane_bounds(np.cumsum([0] + counts),
                                      int(prime_on), 2)
    _, lines, _ = wd.stream_offsets(counts, cols)
    s_offs = np.concatenate([[0], np.cumsum(lines)])
    t0, t1 = np.searchsorted(s_offs, [lo, hi])
    before = _build.LAUNCHES["well_jump"]
    got = port.encode(data, DIST, mesh=make_mesh(devices=["cuda:0", "cpu"]),
                      n_clusters=3, shards=shards, prime=prime,
                      want_recon=False)
    assert _build.LAUNCHES["well_jump"] == before + 1
    assert got.stats.counters["device_jumps"] == t1 - t0 > 0
    assert _sha256(got.compressed) == _golden(3, prime)
