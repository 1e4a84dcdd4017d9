"""KW's plain version and the streams it is given, on the CPU: the
encode's dither draws (``qvz_tpu_torch.ops.well_draws``) against the host
runtime's ``rt.well_draws7`` shard by shard and against ``qvz_tpu``'s
lockstep streams (``well_words_vectorized``, ``draws_from_words``); the
wrapper's checks; a CPU device encode keeps the host's draws, on one
device and on each block of a mesh; the SHA-256 of ``qvz_tpu``'s
containers that the card's encodes compare with. KW itself runs in
``tests/test_torch_well_draws_card.py``."""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.ops import well as jx_well
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.pipeline import encode as jx_encode
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops import coder_device
from qvz_tpu_torch.ops import well_draws as wd
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.parallel.mesh import make_mesh
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host

DIST = make_matrix(DISTORTION_MSE)

# (lines, columns, shards, prime, warmup lines): primed and unprimed
# plans, ragged last shards, lanes whose offsets and lengths are not
# multiples of 16, columns 1, 37 and 100
PLANS = [
    (3001, 37, 8, True, 512),
    (1003, 1, 5, False, 512),
    (2051, 100, 16, True, 256),
    (999, 3, 7, False, 512),
    (1300, 100, 9, False, 512),
    (2600, 1, 4, True, 512),
]
IDS = [f"{n}x{c}-s{s}-{'prime' if p else 'noprime'}"
       for n, c, s, p, _ in PLANS]


def _plan(monkeypatch, n, cols, shards, prime, warmup, seed=0):
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", warmup)
    well = WellState(np.random.default_rng(seed).integers(
        0, 2**32, size=32, dtype=np.uint64))
    return host.shard_plan(n, cols, shards, prime, well)


def _torch_states(states):
    return torch.from_numpy(np.ascontiguousarray(states).view(np.int32))


@pytest.mark.parametrize("plan", PLANS, ids=IDS)
def test_plain_version_matches_host_and_qvz_tpu(monkeypatch, plan):
    """KW's plain version over the encode's streams gives rt.well_draws7's
    draws shard by shard, and qvz_tpu's lockstep streams' draws."""
    n, cols, shards, prime, warmup = plan
    counts, states, offs, prime_on = _plan(monkeypatch, *plan)
    assert prime_on == prime
    s_states, s_lines = wd.stream_plan(states, counts, cols)
    got = wd.draws_t(_torch_states(s_states), s_lines, cols)
    assert got.dtype == torch.uint8 and got.shape == (cols, n)
    got = got.numpy()
    for s, c in enumerate(counts):
        lo, hi = int(offs[s]), int(offs[s + 1])
        want = rt.well_draws7(states[s], c * cols).reshape(c, cols)
        assert np.array_equal(got[:, lo:hi], want.T), s
        st = states[s][None, :].copy()
        words = jx_well.well_words_vectorized(st, -(-c * cols // 4))[0]
        jx = jx_well.draws_from_words(words, c * cols).reshape(c, cols)
        assert np.array_equal(got[:, lo:hi], jx.T), s
    assert np.array_equal(got, host._shard_draws(states, counts, cols).T)


@pytest.mark.parametrize("plan", PLANS, ids=IDS)
def test_streams_cut_only_the_warmup_shard(monkeypatch, plan):
    """Every lane is one stream; a primed plan's warmup shard is cut into
    pieces of the longest lane (rounded up to 4 lines), each piece starts
    on a pool word, from rt.well_jump's state."""
    n, cols, shards, prime, warmup = plan
    counts, states, offs, prime_on = _plan(monkeypatch, *plan)
    s_states, s_lines = wd.stream_plan(states, counts, cols)
    first = 1 if prime_on else 0
    lanes = list(counts[1:] if len(counts) > 1 else counts)
    piece = (max(lanes) + 3) & ~3
    assert s_lines.sum() == n and s_states.shape == (len(s_lines), 32)
    assert list(s_lines[len(s_lines) - len(counts) + 1:]) == lanes \
        if first else list(s_lines) == list(counts)
    k = len(s_lines) - len(counts) + 1
    if first and counts[0] > piece:
        assert k == -(-counts[0] // piece) and k > 1
        assert all(x == piece for x in s_lines[:k - 1])
        assert (piece * cols) % 4 == 0
        want = rt.well_jump(states[0], k, piece * cols // 4)
        assert np.array_equal(s_states[:k], want)
        # the piece's draws continue the warmup shard's stream
        whole = rt.well_draws7(states[0], counts[0] * cols)
        for i in range(k):
            m = int(s_lines[i]) * cols
            assert np.array_equal(
                rt.well_draws7(s_states[i], m),
                whole[i * piece * cols:i * piece * cols + m])
    else:
        assert k == 1
    assert np.array_equal(s_states[k:], states[1:])


def test_streams_of_the_benchmark_file():
    """At 10,000,000 x 100 (--shards 0, primed): 8,171 shards, the
    65,536-line warmup shard in 54 pieces of 1,216 lines, the last of
    1,088, then the 8,170 lanes."""
    n, cols = 10_000_000, 100
    counts, states, _, prime_on = host.shard_plan(
        n, cols, port.device_lane_count(n), True, WellState.debug())
    assert prime_on and len(counts) == 8171 and counts[0] == 65536
    s_states, s_lines = wd.stream_plan(states, counts, cols)
    assert len(s_lines) == 54 + 8170
    assert list(s_lines[:54]) == [1216] * 53 + [1088]
    assert list(s_lines[54:]) == list(counts[1:])
    assert np.array_equal(s_states[54:], states[1:])


def test_words_match_qvz_tpu_lockstep():
    """The plain version's lockstep words are qvz_tpu's, across chunks (of
    a multiple of 32 words, after which the rotating index is 0 again)."""
    rng = np.random.default_rng(7)
    st = rng.integers(0, 2**32, size=(5, 32), dtype=np.uint64) \
        .astype(np.uint32)
    s = torch.from_numpy(st.astype(np.int64))
    got = torch.cat([wd._words_reference(s, 64), wd._words_reference(s, 29)],
                    1)
    want = jx_well.well_words_vectorized(st.copy(), 93)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("case", [
    ("dtype", lambda s: (s.long(), [4, 4], 3), TypeError),
    ("shape", lambda s: (s[:, :31].contiguous(), [4, 4], 3), ValueError),
    ("count", lambda s: (s, [4, 4, 4], 3), ValueError),
    ("flat", lambda s: (s.reshape(-1), [64], 3), ValueError),
    ("lines", lambda s: (s, [4, -1], 3), ValueError),
    ("columns", lambda s: (s, [4, 4], 0), ValueError),
    ("device", lambda s: (s.to("meta"), [4, 4], 3), ValueError),
], ids=lambda c: c[0])
def test_wrapper_rejects(case):
    _, make, err = case
    s = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(err):
        wd.draws_t(*make(s))


def _card_data(n, cols, seed):
    """The reads of tests/test_torch_well_draws_card.py's encodes."""
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.mark.parametrize("n_clusters", [1, 3])
@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_card_encode_golden_is_qvz_tpus_container(monkeypatch, n_clusters,
                                                  prime):
    """The SHA-256 that the card's KW encodes compare their containers
    with (golden/kw_encode_sha256.json) is that of qvz_tpu's container."""
    monkeypatch.setattr(jx_encode, "PRIME_WARMUP_LINES", 512)
    golden = json.loads((pathlib.Path(__file__).parent / "golden"
                         / "kw_encode_sha256.json").read_text())
    n, cols = golden["lines"], golden["columns"]
    out = jx_encode.encode(_card_data(n, cols, n_clusters), DIST,
                           well_state=jx_well.WellState.debug(),
                           use_jax=False, n_clusters=n_clusters,
                           shards=golden["shards"], prime=prime,
                           want_recon=False)
    key = f"{n_clusters}-{'prime' if prime else 'noprime'}"
    assert hashlib.sha256(out.compressed).hexdigest() == \
        golden["sha256"][key]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises((RuntimeError, AssertionError)):
        wd.draws_t(torch.zeros((1, 32), dtype=torch.int32, device="cuda"),
                   [4], 3)


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_cpu_encode_keeps_the_host_draws(monkeypatch, n_clusters):
    """On the CPU the encode fills the draws on the host and copies them:
    device_draws 0, and h2d_bytes the reads, the draws and the lane plan,
    as before KW."""
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 512)
    plans = []
    to_torch = coder_device.plan_to_torch

    def counted(*a, **k):
        plans.append(to_torch(*a, **k))
        return plans[-1]

    monkeypatch.setattr(coder_device, "plan_to_torch", counted)
    rng = np.random.default_rng(n_clusters)
    n, cols = 1500, 6
    data = np.clip(rng.integers(20, 45, size=(n, 1))
                   + rng.integers(-3, 4, size=(n, cols)).cumsum(1), 0,
                   71).astype(np.uint8)
    out = port.encode(data, DIST, n_clusters=n_clusters, shards=8,
                      want_recon=False, device="cpu")
    ct = out.stats.counters
    assert ct["device_draws"] == 0
    assert all(type(v) is int for v in ct.values()), ct
    plan_bytes = sum(v.numel() * v.element_size() for p in plans
                     for v in p.values() if isinstance(v, torch.Tensor))
    assert len(plans) == 1
    assert ct["h2d_bytes"] == 2 * n * cols + plan_bytes
    want = host.encode(data, DIST, n_clusters=n_clusters, shards=8,
                       want_recon=False)
    assert out.compressed == want.compressed


@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_cpu_mesh_fills_each_blocks_draws_on_the_host(monkeypatch, prime):
    """On a mesh of CPU blocks each block's shards get the host's draws:
    device_draws 0, h2d_bytes as on one CPU device, and the container
    the host engine's."""
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 512)
    data = _card_data(1500, 6, 2)
    kw = dict(shards=8, prime=prime, want_recon=False)
    one = port.encode(data, DIST, device="cpu", **kw)
    got = port.encode(data, DIST, mesh=make_mesh(devices=["cpu"] * 3), **kw)
    assert got.stats.counters["device_draws"] == 0
    assert got.stats.counters["h2d_bytes"] == one.stats.counters["h2d_bytes"]
    assert got.compressed == one.compressed
    assert got.compressed == host.encode(data, DIST, **kw).compressed
