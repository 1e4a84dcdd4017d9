"""qvz_tpu_torch's host engine (its own copy of the C++ runtime, formats
and host pipeline) against qvz_tpu's: containers and decodes byte-equal,
the design's blocks and tables equal, and the C reference's golden files
decoded and re-encoded."""

import numpy as np
import pytest

from qvz_tpu.constants import (DISTORTION_CUSTOM, DISTORTION_LORENTZ,
                               DISTORTION_MANHATTAN, DISTORTION_MSE,
                               MODE_FIXED, MODE_RATIO)
from qvz_tpu.format import container_v2 as jc2
from qvz_tpu.native import runtime as jrt
from qvz_tpu.ops.distortion import make_matrix as jx_matrix
from qvz_tpu.ops.well import WellState as JxWell
from qvz_tpu.pipeline import decode as jx_decode
from qvz_tpu.pipeline import encode as jx_encode
from qvz_tpu.spec.pipeline import load_quality_file
from qvz_tpu_torch.format import container_v2
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline import host


def _data(n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.fixture
def small_warmup(monkeypatch):
    """Prime with a 512-line warmup shard in both packages."""
    monkeypatch.setattr(jx_encode, "PRIME_WARMUP_LINES", 512)
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 512)


@pytest.mark.parametrize("dist", [DISTORTION_MSE, DISTORTION_MANHATTAN],
                         ids=["mse", "l1"])
@pytest.mark.parametrize("mode,ratio",
                         [(MODE_RATIO, 0.5), (MODE_FIXED, 1.5)],
                         ids=["f", "r"])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
@pytest.mark.parametrize("n_clusters", [1, 3], ids=["c1", "c3"])
def test_host_encode_matches_qvz_tpu(small_warmup, n_clusters, prime, shards,
                                     mode, ratio, dist):
    data = _data(1300, 8, seed=n_clusters + 7 * shards)
    kw = dict(n_clusters=n_clusters, mode=mode, ratio=ratio, shards=shards,
              prime=prime)
    got = host.encode(data, make_matrix(dist), well_state=WellState.debug(),
                      **kw)
    want = jx_encode.encode(data, jx_matrix(dist), well_state=JxWell.debug(),
                            use_jax=False, **kw)
    assert got.compressed == want.compressed
    assert container_v2.is_v2(got.compressed) == (shards > 1)
    if shards > 1:
        assert bool(jc2.parse(got.compressed, blocks_len=None).priming) \
            == prime
    assert np.array_equal(got.reconstructed, want.reconstructed)
    assert np.array_equal(got.clusters, want.clusters)
    assert got.stats.rate == want.stats.rate
    assert got.stats.distortion == want.stats.distortion
    assert got.stats.payload_bytes == want.stats.payload_bytes
    dec = host.decode(got.compressed)
    assert np.array_equal(dec, jx_decode.decode(want.compressed,
                                                device=False))
    assert np.array_equal(dec[:, :8], got.reconstructed + 33)


def _containers(kind):
    """A container of one kind, made by the port's host engine."""
    data = _data(1600, 6, seed=31)
    dist = make_matrix(DISTORTION_MSE)
    shards = {"v1": 1, "single": 1, "rowmajor": 3, "primed": 4}[kind]
    kw = dict(shards=shards, prime=kind == "primed")
    out = host.encode(data, dist, well_state=WellState.debug(), **kw)
    comp = out.compressed
    if kind == "single":
        # one column-major shard under the QVZ2 directory
        tables = rt.tables_from_blocks(comp[9:], 1, 6)
        pay = rt.encode_fused_colmajor(
            tables, np.ascontiguousarray(data.T), None,
            WellState.debug().state)[0]
        comp = container_v2.build(comp[9:9 + tables.consumed], 1, 6, 1600,
                                  [1600], [WellState.debug().to_bytes()],
                                  [pay])
    elif kind == "rowmajor":
        head = container_v2.parse(comp, blocks_len=None)
        tables = rt.tables_from_blocks(comp[container_v2.header_size():],
                                       head.cluster_count, head.columns)
        head = container_v2.parse(comp, blocks_len=tables.consumed)
        offs = np.concatenate([[0], np.cumsum([s.lines
                                               for s in head.shards])])
        pays = [rt.encode_fused(tables, data[offs[i]:offs[i + 1]], None,
                                np.frombuffer(s.well_state, "<u4"))[0]
                for i, s in enumerate(head.shards)]
        comp = container_v2.build(
            bytes(head.blocks), 1, 6, 1600, [s.lines for s in head.shards],
            [bytes(s.well_state) for s in head.shards], pays,
            order=container_v2.ORDER_LINE)
    return comp


@pytest.mark.parametrize("kind", ["v1", "single", "rowmajor", "primed"])
def test_host_decode_matches_qvz_tpu(small_warmup, kind):
    comp = _containers(kind)
    got = host.decode(comp)
    assert np.array_equal(got, jx_decode.decode(comp, device=False))
    assert got.shape == (1600, 7)


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_design_and_tables_match_qvz_tpu(n_clusters):
    data = _data(3000, 9, seed=5)
    clusters = (np.arange(3000) % n_clusters).astype(np.uint8)
    counts0, cond = rt.stats_host(data, clusters if n_clusters > 1
                                  else None, n_clusters)
    j0, jc = jrt.stats_host(data, clusters, n_clusters)
    assert np.array_equal(counts0, j0) and np.array_equal(cond, jc)
    mine = rt.Design(counts0, cond, MODE_RATIO, 0.5,
                     make_matrix(DISTORTION_MSE))
    theirs = jrt.Design(j0, jc, MODE_RATIO, 0.5,
                        jx_matrix(DISTORTION_MSE))
    assert mine.serialized() == theirs.serialized()
    a, b = mine.tables(), theirs.tables()
    for name in ("pair_base", "ctxmap", "qratio", "model_card", "model_off",
                 "model_syms", "qv_map", "qs_map"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.n_pairs, a.n_models, a.bank_words) \
        == (b.n_pairs, b.n_models, b.bank_words)


GOLDEN = [
    ("tiny_f05", "tiny.in", 1, MODE_RATIO, 0.5, DISTORTION_MSE),
    ("tiny_r2", "tiny.in", 1, MODE_FIXED, 2.0, DISTORTION_MSE),
    ("r2_mse", "small.in", 1, MODE_FIXED, 2.0, DISTORTION_MSE),
    ("r1_mse", "small.in", 1, MODE_FIXED, 1.0, DISTORTION_MSE),
    ("f05_mse", "small.in", 1, MODE_RATIO, 0.5, DISTORTION_MSE),
    ("f05_lorentz", "small.in", 1, MODE_RATIO, 0.5, DISTORTION_LORENTZ),
    ("f05_l1", "small.in", 1, MODE_RATIO, 0.5, DISTORTION_MANHATTAN),
    ("f09_mse", "small.in", 1, MODE_RATIO, 0.9, DISTORTION_MSE),
    ("f00_mse", "small.in", 1, MODE_RATIO, 0.0, DISTORTION_MSE),
    ("c3_f05", "small.in", 3, MODE_RATIO, 0.5, DISTORTION_MSE),
    ("med_f05", "med.in", 1, MODE_RATIO, 0.5, DISTORTION_MSE),
    ("med_c4", "med.in", 4, MODE_RATIO, 0.4, DISTORTION_MSE),
    ("g_col1", "g_col1.in", 1, MODE_RATIO, 0.5, DISTORTION_MSE),
    ("g_custom", "g_custom.in", 1, MODE_RATIO, 0.3, DISTORTION_CUSTOM),
]


@pytest.mark.parametrize("name,inp,clusters,mode,ratio,dist", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_goldens_decode_and_reencode(golden_dir, name, inp, clusters, mode,
                                     ratio, dist):
    """The port's host engine decodes each C-reference container to its
    .u file, and re-encodes it byte-equal from the golden's input."""
    golden = (golden_dir / f"{name}.q").read_bytes()
    assert host.decode(golden).tobytes() \
        == (golden_dir / f"{name}.u").read_bytes()
    data = load_quality_file(str(golden_dir / inp))
    matrix = make_matrix(dist, path=str(golden_dir / "g_custom_dist.txt")
                         if dist == DISTORTION_CUSTOM else None)
    out = host.encode(data, matrix, n_clusters=clusters, mode=mode,
                      ratio=ratio, well_state=WellState.debug(), shards=1)
    assert out.compressed == golden


def test_kmeans_iter_matches_qvz_tpu():
    """One Lloyd iteration over a row range (the drivers' chunked
    k-means): assignment, sums and counts equal to qvz_tpu's."""
    data = _data(5000, 12, seed=9)
    means = data[[3, 1000, 4000, 4000]].astype(np.int64)  # a tie too
    for got, want in zip(rt.kmeans_iter(data, means),
                         jrt.kmeans_iter(data, means)):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_stats_host_accumulate_matches_qvz_tpu(n_clusters):
    """Chunked statistics added into uint64 accumulators: the sums of
    qvz_tpu's, and of one pass over all the rows."""
    data = _data(3000, 9, seed=6)
    clusters = ((np.arange(3000) * 7) % n_clusters).astype(np.uint8)
    cl = clusters if n_clusters > 1 else None
    acc = [(np.zeros((n_clusters, 72), np.uint64),
            np.zeros((n_clusters, 8, 72, 72), np.uint64)) for _ in range(2)]
    for lo in range(0, 3000, 700):
        part = None if cl is None else cl[lo:lo + 700]
        rt.stats_host(data[lo:lo + 700], part, n_clusters,
                      accumulate=acc[0])
        jrt.stats_host(data[lo:lo + 700], part, n_clusters,
                       accumulate=acc[1])
    whole = rt.stats_host(data, cl, n_clusters)
    for a, b, w in zip(acc[0], acc[1], whole):
        assert a.dtype == np.uint64
        assert np.array_equal(a, b) and np.array_equal(a, w)


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_encode_precomputed_want_bank_matches_qvz_tpu(n_clusters):
    """The warmup shard coded from precomputed streams with its bank
    returned (the streaming encode's primed path): payload and bank equal
    to qvz_tpu's, and the payload to the one coded without the bank."""
    data = _data(2000, 10, seed=7)
    cl = ((np.arange(2000) * 5) % 3).astype(np.uint8) \
        if n_clusters > 1 else None
    c0, cond = rt.stats_host(data, cl, n_clusters)
    dist = make_matrix(DISTORTION_MSE)
    mine = rt.Design(c0, cond, MODE_RATIO, 0.5, dist).tables()
    theirs = jrt.Design(c0, cond, MODE_RATIO, 0.5,
                        jx_matrix(DISTORTION_MSE)).tables()
    state = np.asarray(WellState.debug().state, dtype=np.uint32)
    md, qs, _, _ = rt.quantize_colmajor(
        mine, np.ascontiguousarray(data.T), cl, state)
    pay, bank = rt.encode_precomputed_colmajor(mine, md, qs, cl, 2000,
                                               want_bank=True)
    jpay, jbank = jrt.encode_precomputed_colmajor(theirs, md, qs, cl, 2000,
                                                  want_bank=True)
    assert pay == jpay and np.array_equal(bank, jbank)
    assert pay == rt.encode_precomputed_colmajor(mine, md, qs, cl, 2000)
    assert np.array_equal(bank, rt.bank_from_stream(mine, md, qs, cl, 2000))
    # the bank primes the next shard as qvz_tpu's does
    assert rt.encode_precomputed_colmajor(mine, md, qs, cl, 2000,
                                          init_bank=bank) \
        == jrt.encode_precomputed_colmajor(theirs, md, qs, cl, 2000,
                                           init_bank=jbank)
