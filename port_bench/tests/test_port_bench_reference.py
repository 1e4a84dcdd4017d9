"""The plain reference (port_bench/reference) against the program run
with device="cpu" (the kernels' plain versions) at small sizes: the
containers byte-equal and the program's decode equal to the reference's
reconstruction, at -c 1 and -c 3, primed and unprimed."""

import numpy as np
import pytest

from port_bench import inputs
from port_bench.reference import qvz2

GEN = {"start": [28, 39], "step": [-2, 2], "drift_every": 40,
       "clip": [2, 41]}


@pytest.mark.parametrize("clusters", [1, 3])
@pytest.mark.parametrize("prime", [True, False])
def test_reference_equals_program(monkeypatch, clusters, prime):
    from qvz_tpu_torch import api
    from qvz_tpu_torch.pipeline import decode, host
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 256)
    seed = 1000 + clusters + 10 * prime
    text = inputs.make_pool(seed, 1, 2000, 20, GEN, "cpu")[0]
    wseed = inputs.well_seed(seed)
    cfg = qvz2.Config(clusters, 0.5, 4.0, 8, prime, 256)
    data = qvz2.parse_text(text)
    state = np.frombuffer(wseed, dtype="<u4")
    want = qvz2.encode(data, cfg, state)
    got, _ = api.compress_bytes(text, clusters=clusters, shards=8,
                                prime=prime, well_seed=wseed, device="cpu")
    assert got == want
    out = decode.decode(got, device="cpu")
    assert np.array_equal(out, qvz2.to_text(qvz2.recon(data, cfg, state)))


def test_plan_is_the_lane_count():
    cfg = qvz2.Config(1, 0.5, 4.0, 0, True, 65536)
    counts, primed = qvz2.plan(10_000_000, cfg)
    assert primed and counts[0] == 65536
    assert len(counts) == 8171 and counts[1] == 1216 and counts[-1] == 960
    assert sum(counts) == 10**7


@pytest.mark.parametrize("clusters", [1, 3])
def test_checked_view_is_the_program_s(monkeypatch, clusters):
    """The View of the lanes drawn from the seed holds alike with the
    program's container, and with the reference's whole one; a byte off
    in the head, a directory entry or a drawn lane is caught, one in a
    lane not drawn is not looked at."""
    from qvz_tpu_torch import api
    from qvz_tpu_torch.pipeline import host
    from port_bench.ops import encode
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 256)
    monkeypatch.setattr(encode, "CHECKED_LANES", 4)
    cfg = dict(columns=12, ratio=0.5, clusters=clusters,
               cluster_threshold=4.0, shards=24, prime=True,
               warmup_lines=256)
    seed = 77 + clusters
    text = inputs.make_pool(seed, 1, 3000, 12, GEN, "cpu")[0]
    wseed = inputs.well_seed(seed)
    shards = encode.checked_shards(3000, cfg, seed)
    assert 0 in shards and 1 in shards and 24 in shards
    assert len(shards) == 7
    want = encode.expected(text, cfg, wseed, seed)
    assert sorted(want.pays) == shards
    got, _ = api.compress_bytes(text, clusters=clusters, shards=24,
                                prime=True, well_seed=wseed, device="cpu")
    assert encode.compare([got], want) == {"checked_bytes_off": (0, 0)}
    data = qvz2.parse_text(text)
    full = qvz2.encode(data, encode.qvz2_config(cfg),
                       np.frombuffer(wseed, dtype="<u4"))
    assert full == got
    view = qvz2.read_view(got, len(want.head))
    at = len(want.head) + 152 * 25
    offsets = {}
    for s_ in range(25):
        offsets[s_] = at
        at += len(view.pays[s_][0])
    skipped = next(s_ for s_ in range(25) if s_ not in shards)
    for where, caught in ((len(want.head) // 2, True),
                          (len(want.head) + 152 * 3 + 30, True),
                          (offsets[shards[-2]] + 1, True),
                          (offsets[skipped] + 1, False)):
        bad = bytearray(got)
        bad[where] ^= 1
        off = encode.compare([bytes(bad)], want)["checked_bytes_off"][0]
        assert (off > 0) == caught, where


def test_xxh64_known_values():
    assert qvz2.xxh64(b"") == 0xEF46DB3751D8E999
    from qvz_tpu_torch.native import runtime as rt
    rng = np.random.default_rng(3)
    for n in (1, 7, 31, 32, 33, 100, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert qvz2.xxh64(data) == rt.xxh64(data)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lloyd_max_batch_equals_the_loop(dtype):
    """The batched Lloyd-Max (nonzero terms only, regions by running
    counts, the walk as a running maximum) against quantizer.c's loops
    written out one by one, on pmfs with empty and repeated cells."""
    from port_bench.reference import design
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 50, (60, 72)) * (rng.random((60, 72)) < 0.3)
    counts[:, 2] += 1
    pmf = design._pmf(counts, np.dtype(dtype).type)
    states = rng.integers(1, 30, 60)
    dist = design.mse_matrix(dtype)
    maps, rec = design.lloyd_max(pmf, states, dist)
    for b in range(60):
        q, r = design._lloyd_scalar(pmf[b].tolist(), int(states[b]), dist)
        assert np.array_equal(maps[b], q)
        assert np.array_equal(rec[b, :states[b]], r)
