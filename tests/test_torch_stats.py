"""qvz_tpu_torch conditional statistics (K3's plain version) against
qvz_tpu: the Pallas kernel pallas_kernels._hist_kernel in interpret mode,
the XLA scan of qvz_tpu.ops.stats.conditional_counts and the host C++
counts rt.stats_host; K3's launch planner hist_shape, and a numpy replay
of the reads and pairs each block of a plan counts. Counts are integers,
so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qvz_tpu.native import runtime as rt
from qvz_tpu.ops import stats as jx_stats
from qvz_tpu.ops.pallas_kernels import cond_hist_fused, pad_rows
from qvz_tpu_torch.ops import stats as tstats


def _case(n, cols, n_cl, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    clusters = rng.integers(0, n_cl, size=n).astype(np.uint8)
    return data, clusters


def _port(data, clusters, n_cl):
    c0, cond = tstats.conditional_counts_t(
        torch.from_numpy(np.ascontiguousarray(data.T)),
        torch.from_numpy(clusters), n_cl)
    assert c0.dtype == cond.dtype == torch.int64
    return c0.numpy(), cond.numpy()


# (n, cols, clusters): one cluster, three, and twelve (past the clusters
# one block of K3 holds in shared memory); ragged N (not a multiple of
# the Pallas kernel's 512-row block) throughout, and one column.
GEOMS = [(1100, 50, 1), (1333, 20, 3), (777, 9, 12), (600, 1, 3)]


@pytest.mark.parametrize("geom", GEOMS,
                         ids=[f"{n}x{c}c{k}" for n, c, k in GEOMS])
def test_conditional_counts_match_qvz_tpu(geom):
    n, cols, n_cl = geom
    data, clusters = _case(n, cols, n_cl, seed=n + cols)
    c0, cond = _port(data, clusters, n_cl)
    assert c0.shape == (n_cl, 72) and cond.shape == (n_cl, cols - 1, 72, 72)
    h0, hc = rt.stats_host(data, clusters, n_cl)
    assert np.array_equal(c0, h0) and np.array_equal(cond, hc)
    j0, jc = jx_stats.conditional_counts(data, clusters, n_cl)
    assert np.array_equal(c0, j0) and np.array_equal(cond, jc)
    assert c0.sum() == n and cond.sum() == n * (cols - 1)


@pytest.mark.parametrize("geom", GEOMS[:3],
                         ids=[f"{n}x{c}c{k}" for n, c, k in GEOMS[:3]])
def test_conditional_counts_match_hist_kernel(geom):
    """The Pallas _hist_kernel (interpret mode) returns cond as
    (cols-1, C*72, 72) int32 over the valid rows of the padded input."""
    n, cols, n_cl = geom
    data, clusters = _case(n, cols, n_cl, seed=n + cols)
    dp = pad_rows(data)
    clp = np.pad(clusters, (0, dp.shape[0] - n))
    want = np.asarray(cond_hist_fused(jnp.asarray(dp), jnp.asarray(clp),
                                      jnp.int32(n), n_cl, interpret=True))
    _, cond = _port(data, clusters, n_cl)
    got = cond.transpose(1, 0, 2, 3).reshape(cols - 1, n_cl * 72, 72)
    assert np.array_equal(got, want)


def test_conditional_counts_without_clusters_and_from_rows():
    """clusters=None is one cluster; conditional_counts takes (N, cols)."""
    data, _ = _case(900, 7, 1, seed=2)
    a = tstats.conditional_counts(torch.from_numpy(data), None, 1)
    b = _port(data, np.zeros(900, np.uint8), 1)
    for x, y in zip(a, b):
        assert np.array_equal(x.numpy(), y)


def test_conditional_counts_rejects_bad_inputs():
    data, clusters = _case(100, 4, 2, seed=1)
    d = torch.from_numpy(np.ascontiguousarray(data.T))
    with pytest.raises(TypeError):
        tstats.conditional_counts_t(d.int(), None, 1)
    with pytest.raises(ValueError):
        tstats.conditional_counts_t(d, torch.from_numpy(clusters[:50]), 2)
    with pytest.raises(ValueError):
        tstats.conditional_counts_t(d, torch.from_numpy(clusters).int(), 2)
    with pytest.raises(ValueError):
        tstats.conditional_counts_t(d, None, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cl", [1, 3, 12])
def test_hist_kernel_matches_reference(n_cl):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    data, clusters = _case(5000, 30, n_cl, seed=n_cl)
    want = _port(data, clusters, n_cl)
    got = tstats.conditional_counts_t(
        torch.from_numpy(np.ascontiguousarray(data.T)).cuda(),
        torch.from_numpy(clusters).cuda(), n_cl)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert np.array_equal(a, b.cpu().numpy())


# NovaSeq (Illumina RTA3) bins qualities to four Phred values
NOVASEQ = np.array([2, 12, 23, 37], dtype=np.uint8)


def _binned(data):
    """Each symbol to the nearest of NOVASEQ (the lower on a tie)."""
    d = np.abs(data[..., None].astype(np.int16) - NOVASEQ.astype(np.int16))
    return NOVASEQ[d.argmin(-1)]


@pytest.mark.parametrize("geom", [(1500, 40, 1), (1500, 40, 3),
                                  (900, 12, 255)],
                         ids=["binned_c1", "binned_c3", "binned_c255"])
def test_binned_and_255_clusters_match_qvz_tpu(geom):
    """The plain version on NovaSeq-binned qualities (most of a column's
    reads in one or two bins) and at 255 clusters, against the host C++
    counts and qvz_tpu's conditional_counts."""
    n, cols, n_cl = geom
    data, clusters = _case(n, cols, n_cl, seed=n_cl)
    data = _binned(data)
    assert set(np.unique(data)) <= set(NOVASEQ.tolist())
    c0, cond = _port(data, clusters, n_cl)
    h0, hc = rt.stats_host(data, clusters, n_cl)
    assert np.array_equal(c0, h0) and np.array_equal(cond, hc)
    j0, jc = jx_stats.conditional_counts(data, clusters, n_cl)
    assert np.array_equal(c0, j0) and np.array_equal(cond, jc)
    assert cond.sum() == n * (cols - 1)


# the H100's shared memory a block and an SM, and its SMs
H100 = (232_448, 233_472, 132)


@pytest.mark.parametrize("geom,want", [
    # the main path: two blocks of 512 an SM and 5 pairs a band at C = 1,
    # one block of 1,024 and 3 pairs at C = 3 (two blocks would fit one
    # pair, reading every column and the ids once a pair)
    ((1_000_000, 100, 1), {"mode": 0, "band": 5,
                           "nbands": 20,
                           "threads": 512, "blocks_per_sm": 2,
                           "nslices": 13, "smem": 103_968}),
    ((1_000_000, 100, 3), {"mode": 0, "band": 3,
                           "nbands": 33,
                           "threads": 1024, "blocks_per_sm": 1,
                           "nslices": 4, "smem": 187_488}),
    # phase 16's -c 150: device memory, bands narrowed to fill the card
    ((200_000, 20, 150), {"mode": 1, "band": 1,
                          "nbands": 19, "smem": 0, "threads": 512}),
    ((1, 1, 1), {"mode": 0, "nbands": 1, "nslices": 1, "slice": 16,
                 "smem": 288}),
    ((1037, 1, 3), {"mode": 0, "nbands": 1, "nslices": 1, "smem": 864}),
    ((4099, 2, 1), {"mode": 0, "band": 1, "nbands": 1, "nslices": 1}),
    # 11 clusters: one pair fills a block's shared memory; 12 do not fit
    ((5000, 100, 11), {"mode": 0, "band": 1, "threads": 1024,
                       "smem": 231_264}),
    ((5000, 100, 12), {"mode": 1, "smem": 0}),
    ((3000, 30, 255), {"mode": 1, "smem": 0}),
    # past 2^31 reads: every slice below 2^31
    ((3 * 2 ** 31, 100, 1), {"mode": 0, "band": 5, "nslices": 13}),
    ((2 ** 34, 4, 3), {"mode": 0, "nbands": 1}),
], ids=lambda g: "x".join(map(str, g)) if isinstance(g, tuple) else "")
def test_hist_shape(geom, want):
    """K3's plan under the H100's limits: the main path's shapes, the odd
    ones, and the invariants the kernel checks (qvz_hist): slices of
    GROUP reads below 2^31 that cover N once, the bands that cover the
    pairs, mode 0's layout within a block's shared memory."""
    n, cols, c = geom
    got = tstats.hist_shape(n, cols, c, *H100)
    assert {k: got[k] for k in want} == want
    pairs = cols - 1
    assert got["slice"] % tstats.GROUP == 0
    assert got["slice"] < tstats.MAX_SLICE
    assert (got["nslices"] - 1) * got["slice"] < n \
        <= got["nslices"] * got["slice"]
    assert got["nbands"] == (-(-pairs // got["band"]) if pairs else 1)
    assert 1 <= got["band"] <= max(pairs, 1)
    assert got["threads"] % 32 == 0 and got["threads"] <= 1024
    if got["mode"] == 0:
        assert c <= tstats.MAX_SHARED_CLUSTERS
        assert got["smem"] == tstats.layout_bytes(cols, c, got["band"]) \
            <= H100[0]
        assert got["blocks_per_sm"] * (got["smem"] + tstats.SMEM_RESERVED) \
            <= H100[1]
    else:
        assert tstats.layout_bytes(cols, c, 1) > H100[0] \
            or c > tstats.MAX_SHARED_CLUSTERS
    if n * got["nbands"] >= 4 * H100[2] * 1024 * tstats.GROUP:
        # a large input leaves no tail wave worth more than TAIL
        assert got["fill"] >= tstats.TAIL


def test_hist_shape_rejects_what_the_kernel_cannot_take():
    for geom in ((0, 10, 1), (10, 0, 1), (10, 10, 0), (10, 10, 256)):
        with pytest.raises(ValueError):
            tstats.hist_shape(*geom, *H100)


def _replay(data, clusters, n_cl, plan):
    """The counts K3 gives in `plan`, block by block as csrc/hist.cu
    assigns them: block (s, b) takes reads [s * slice, min(N, (s + 1) *
    slice)) in rounds of GROUP x threads, thread t the GROUP reads from
    round + GROUP * t, and pairs p0 = 1 + b * band onward (band 0 also
    column 0). Also returns how often each (pair, read) was counted."""
    n, cols = data.shape
    A = 72
    g, threads = tstats.GROUP, plan["threads"]
    counts0 = np.zeros((n_cl, A), np.int64)
    cond = np.zeros((n_cl, max(cols - 1, 0), A, A), np.int64)
    seen = np.zeros((cols, n), np.int64)
    for s in range(plan["nslices"]):
        lo = s * plan["slice"]
        hi = min(n, lo + plan["slice"])
        rounds = np.arange(lo, hi, g * threads)
        r = (rounds[:, None, None] + g * np.arange(threads)[None, :, None]
             + np.arange(g)[None, None, :]).reshape(-1)
        reads = r[r < hi]
        q = clusters[reads].astype(np.int64)
        for b in range(plan["nbands"]):
            p0 = 1 + b * plan["band"]
            if b == 0:
                np.add.at(counts0, (q, data[reads, 0]), 1)
                seen[0, reads] += 1
            for p in range(p0, min(cols, p0 + plan["band"])):
                np.add.at(cond, (q, p - 1, data[reads, p - 1],
                                 data[reads, p]), 1)
                seen[p, reads] += 1
    return counts0, cond, seen


REPLAYS = [
    # (n, cols, C, card): several slices, rounds and bands, ragged N
    (3000, 30, 3, (65_536, 131_072, 4)),
    (2500, 9, 1, (49_152, 100_000, 3)),
    (1500, 12, 14, H100[:2] + (8,)),
    (4099, 2, 1, H100[:2] + (2,)),
    (777, 1, 5, H100[:2] + (1,)),
    (3000, 30, 255, H100[:2] + (2,)),
]


@pytest.mark.parametrize("case", REPLAYS,
                         ids=[f"{n}x{c}c{k}" for n, c, k, _ in REPLAYS])
def test_hist_plan_counts_every_pair_and_read_once(case, monkeypatch):
    """A numpy replay of the plan (blocks of 32 threads, so that one
    small input takes several slices, rounds and bands) adds up to the
    plain version and to qvz_tpu's conditional_counts: every (pair,
    cluster, read) is counted exactly once."""
    n, cols, n_cl, card = case
    monkeypatch.setattr(tstats, "THREADS", 32)
    plan = tstats.hist_shape(n, cols, n_cl, *card)
    assert plan["nslices"] > 1 or plan["nbands"] > 1 or cols <= 2
    data, clusters = _case(n, cols, n_cl, seed=cols)
    c0, cond, seen = _replay(data, clusters, n_cl, plan)
    assert (seen == 1).all()
    p0, pc = _port(data, clusters, n_cl)
    assert np.array_equal(c0, p0) and np.array_equal(cond, pc)
    j0, jc = jx_stats.conditional_counts(data, clusters, n_cl)
    assert np.array_equal(c0, j0) and np.array_equal(cond, jc)


def test_conditional_counts_takes_a_shape_only_on_the_card(monkeypatch):
    """The CPU path is the plain version and never asks the card's
    planner for a shape."""
    def no_card(*args):
        raise AssertionError("the CPU path asked for K3's shape")

    monkeypatch.setattr(tstats, "card_hist_shape", no_card)
    data, clusters = _case(500, 6, 3, seed=4)
    got = tstats.conditional_counts_t(
        torch.from_numpy(np.ascontiguousarray(data.T)),
        torch.from_numpy(clusters), 3)
    j0, jc = jx_stats.conditional_counts(data, clusters, 3)
    assert np.array_equal(got[0].numpy(), j0)
    assert np.array_equal(got[1].numpy(), jc)


# (n, cols, C, out-of-range ids): the phase-7 odd shapes; the last two
# give some reads an id at or past C, which K3 does not count
ODD = [(1, 1, 1, 0), (1037, 1, 3, 0), (4099, 2, 1, 0), (5000, 100, 11, 0),
       (5000, 100, 12, 0), (3000, 30, 255, 0), (3001, 7, 2, 0),
       (3001, 7, 2, 40), (2000, 9, 12, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", ODD, ids=["x".join(map(str, g))
                                           for g in ODD])
def test_hist_kernel_odd_shapes(geom):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    n, cols, n_cl, bad = geom
    data, clusters = _case(n, cols, n_cl, seed=n)
    rng = np.random.default_rng(n)
    clusters[rng.choice(n, bad, replace=False)] = rng.integers(
        n_cl, 256, bad)
    keep = clusters < n_cl
    d = torch.from_numpy(np.ascontiguousarray(data.T)).cuda()
    got = tstats.conditional_counts_t(d, torch.from_numpy(clusters).cuda(),
                                      n_cl)
    want = tstats.conditional_counts_reference(
        d[:, torch.from_numpy(keep).cuda()],
        torch.from_numpy(clusters[keep]).cuda(), n_cl)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
