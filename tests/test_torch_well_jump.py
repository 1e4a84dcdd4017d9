"""KJ's plain version and the streams it is given, on the CPU: the start
states of the encode's WELL streams (``qvz_tpu_torch.ops.well_jump``)
against the host runtime's chained ``rt.well_jump``, at single offsets and
on the streams of QVZ2 plans (``well_draws.stream_offsets``) against
``stream_plan``'s states; the wrapper's checks; a CPU device encode keeps
the host's jump. KJ itself runs in ``tests/test_torch_well_jump_card.py``."""

import numpy as np
import pytest
import torch

from qvz_tpu_torch.constants import DISTORTION_MSE
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops import coder_device
from qvz_tpu_torch.ops import well_draws as wd
from qvz_tpu_torch.ops import well_jump as wj
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host

DIST = make_matrix(DISTORTION_MSE)

# (lines, columns, shards, prime, warmup lines): primed and unprimed
# plans, ragged last shards, columns 1, 3, 37, 100 and 151
PLANS = [
    (3001, 37, 8, True, 512),
    (1003, 1, 5, False, 512),
    (2051, 100, 16, True, 256),
    (999, 3, 7, False, 512),
    (4003, 151, 12, True, 512),
    (2600, 1, 4, True, 512),
]
IDS = [f"{n}x{c}-s{s}-{'prime' if p else 'noprime'}"
       for n, c, s, p, _ in PLANS]


def _v0(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2**32, size=32, dtype=np.uint64).astype(np.uint32)


def _host_state(v0: np.ndarray, offset: int) -> np.ndarray:
    """rt.well_jump's state `offset` words after v0."""
    return rt.well_jump(v0, 2, offset)[1] if offset else v0


def _states(v0, offsets) -> np.ndarray:
    got = wj.states_t(v0, np.asarray(offsets, dtype=np.int64), "cpu")
    assert got.dtype == torch.int32 and got.shape == (len(offsets), 32)
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("offsets", [
    [0],
    [1, 2, 1 << 17, 1 << 27],
    [2**28 - 1, 249_976_000, 264_245_453, 0x0AAAAAAA],
    [2**32 + 30_400, 2**33 - 1],
], ids=["zero", "one-bit", "28-bit", "past-2^32"])
def test_plain_version_matches_host_jump(offsets):
    """Row t is rt.well_jump's state offsets[t] words on: none (v0
    itself), single bits, 28-bit offsets (the benchmark files' largest
    lie below 2^28) and offsets past 2^32 words."""
    v0 = _v0(len(offsets))
    got = _states(v0, offsets)
    for o, row in zip(offsets, got):
        assert np.array_equal(row, _host_state(v0, o)), o


def test_table_is_the_word_step_squared():
    """The table's first matrix is one word step, and each next one the
    square of the one before (its rows applied twice)."""
    table = wj.table_t(torch.device("cpu"))
    assert table.shape == (64, 1024, 32) and table.dtype == torch.int32
    v0 = _v0(9)
    for k in (0, 1, 6, 40):
        state = wj.states_t_reference(torch.from_numpy(v0.view(np.int32)),
                                      torch.tensor([1 << k]), table)
        assert np.array_equal(state.numpy().view(np.uint32)[0],
                              _host_state(v0, 1 << k)), k


@pytest.mark.parametrize("plan", PLANS, ids=IDS)
def test_stream_offsets_rebuild_stream_plan(monkeypatch, plan):
    """The streams' word offsets, from the plan's counts alone, jumped from
    the file's state give stream_plan's states (the host's chained jump of
    the shards, then of the warmup shard's pieces) and its lines."""
    n, cols, shards, prime, warmup = plan
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", warmup)
    well = WellState(np.random.default_rng(n).integers(
        0, 2**32, size=32, dtype=np.uint64))
    counts, states, offs, prime_on = host.shard_plan(n, cols, shards, prime,
                                                     well)
    assert prime_on == prime
    words, lines, first = wd.stream_offsets(counts, cols)
    assert words.dtype == np.int64 and lines.dtype == np.int64
    s_states, s_lines = wd.stream_plan(states, counts, cols)
    assert np.array_equal(lines, s_lines) and lines.sum() == n
    # each shard's first stream starts at the shard's first line
    assert np.array_equal(np.concatenate([[0], np.cumsum(lines)])[first],
                          offs[:-1])
    got = _states(host._state_words(well), words)
    assert np.array_equal(got, s_states)
    assert np.array_equal(got[first], states)


@pytest.mark.parametrize("n,cols,streams", [
    (10_000_000, 100, 54 + 8170), (7_000_000, 151, 78 + 8178)],
    ids=["c3-encode-10m", "nova-encode-7m"])
def test_streams_of_the_benchmark_files(n, cols, streams):
    """The benchmark files' plans (--shards 0, primed): the streams KJ
    jumps, the warmup shard's pieces and the lanes, with offsets below
    2^28 words."""
    counts, prime_on = host.shard_counts(n, cols, port.device_lane_count(n),
                                         True)
    assert prime_on
    words, lines, first = wd.stream_offsets(counts, cols)
    assert len(words) == streams and len(first) == len(counts)
    assert lines.sum() == n and int(words.max()) < 2**28
    assert np.array_equal(words[first],
                          (np.cumsum(counts) - counts) * cols // 4)


@pytest.mark.parametrize("case", [
    ("v0-dtype", lambda v, o: (v.astype(np.int64), o), TypeError),
    ("v0-tensor", lambda v, o: (torch.from_numpy(v.view(np.int32)), o),
     TypeError),
    ("v0-shape", lambda v, o: (v[:31], o), ValueError),
    ("offsets-dtype", lambda v, o: (v, o.astype(np.int32)), TypeError),
    ("offsets-list", lambda v, o: (v, list(o)), TypeError),
    ("offsets-shape", lambda v, o: (v, o.reshape(1, -1)), ValueError),
    ("negative", lambda v, o: (v, o - 5), ValueError),
], ids=lambda c: c[0])
def test_wrapper_rejects(case):
    _, make, err = case
    v0 = _v0(1)
    with pytest.raises(err):
        wj.states_t(*make(v0, np.array([0, 3, 4], dtype=np.int64)), "cpu")


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        wj.states_t(_v0(1), np.array([1], dtype=np.int64), "meta")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises((RuntimeError, AssertionError)):
        wj.states_t(_v0(1), np.array([1], dtype=np.int64), "cuda")


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_cpu_encode_keeps_the_host_jump(monkeypatch, n_clusters):
    """On the CPU the encode jumps on the host (shard_plan) and launches no
    KJ: device_jumps 0, and h2d_bytes the reads, the host's draws and the
    lane plan, as before KJ; the container is the host engine's."""
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 512)
    plans = []
    to_torch = coder_device.plan_to_torch

    def counted(*a, **k):
        plans.append(to_torch(*a, **k))
        return plans[-1]

    monkeypatch.setattr(coder_device, "plan_to_torch", counted)
    jumps = []
    monkeypatch.setattr(wj, "states_t", lambda *a: jumps.append(a))
    rng = np.random.default_rng(n_clusters + 10)
    n, cols = 1500, 7
    data = np.clip(rng.integers(20, 45, size=(n, 1))
                   + rng.integers(-3, 4, size=(n, cols)).cumsum(1), 0,
                   71).astype(np.uint8)
    kw = dict(n_clusters=n_clusters, shards=8, want_recon=False)
    out = port.encode(data, DIST, device="cpu", **kw)
    ct = out.stats.counters
    assert ct["device_jumps"] == 0 and ct["device_draws"] == 0
    assert not jumps
    plan_bytes = sum(v.numel() * v.element_size() for p in plans
                     for v in p.values() if isinstance(v, torch.Tensor))
    assert ct["h2d_bytes"] == 2 * n * cols + plan_bytes
    assert out.compressed == host.encode(data, DIST, **kw).compressed
