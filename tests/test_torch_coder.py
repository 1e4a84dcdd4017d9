"""qvz_tpu_torch lane coder (K2's plain version) against qvz_tpu's device
coder: the Pallas kernel coder_pallas._kernel3 in interpret mode and the
CPU XLA scan. Payloads are bytes and flags booleans, so every comparison
is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qvz_tpu.constants import ARITH_R, DISTORTION_MSE, MODE_RATIO
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops import coder_device as jcd
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu_torch.ops import coder_device as cd


def _streams(n, cols, seed, ratio=0.5):
    """Tables and host-quantized (mid, qs) (cols, n) streams."""
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    c0, cond = rt.stats_host(data, None, 1)
    tables = rt.Design(c0, cond, MODE_RATIO, ratio,
                       make_matrix(DISTORTION_MSE)).tables()
    ws = WellState.debug()
    words = np.asarray(ws.state, dtype=np.uint32)[
        [(ws.n + i) & 31 for i in range(32)]]
    md, qs, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data.T), None, words)
    return tables, md, qs


def _lanes(n, base, per):
    """Equal lanes of `per` lines after `base`, the last one ragged."""
    counts, left = [], n - base
    while left > 0:
        counts.append(min(per, left))
        left -= counts[-1]
    return counts


def _jax(tables, bank, md, qs, lane_counts, base):
    return jcd.encode_lanes_raw(
        jcd.LanePlan(tables, bank), jnp.asarray(md.astype(np.int32)),
        jnp.asarray(qs.astype(np.int32)), lane_counts, base, None)


def _port(tables, bank, md, qs, lane_counts, base):
    return cd.encode_lanes_raw(
        cd.plan_to_torch(cd.LanePlan(tables, bank), "cpu"),
        torch.from_numpy(md.astype(np.int32)),
        torch.from_numpy(qs.astype(np.int32)), lane_counts, base)


def _assert_same(want, got):
    (wp, wf), (gp, gf) = want, got
    assert np.array_equal(np.asarray(wf, dtype=bool), gf)
    assert len(wp) == len(gp)
    for w, (a, b) in enumerate(zip(wp, gp)):
        assert a == b, f"lane {w}"


# QVZ_TPU_CODER_PALLAS: "interpret" runs the Pallas kernel (#3) through
# the interpreter; the default takes the CPU XLA scan.
CODERS = ["interpret", "xla"]


@pytest.fixture(params=CODERS)
def coder(request, monkeypatch):
    if request.param == "interpret":
        monkeypatch.setenv("QVZ_TPU_CODER_PALLAS", "interpret")
    else:
        monkeypatch.delenv("QVZ_TPU_CODER_PALLAS", raising=False)
    return request.param


@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_encode_lanes_reference_matches_jax(coder, prime):
    n, cols = 1003, 8
    tables, md, qs = _streams(n, cols, seed=11)
    base, bank = 0, None
    if prime:
        base = 100
        bank = rt.bank_from_stream(tables, md[:, :base], qs[:, :base],
                                   None, base)
    lane_counts = _lanes(n, base, 228 if prime else 252)
    assert lane_counts[-1] < lane_counts[0]      # ragged last lane
    want = _jax(tables, bank, md, qs, lane_counts, base)
    got = _port(tables, bank, md, qs, lane_counts, base)
    assert not got[1].any()
    _assert_same(want, got)


def _flagging_bank(tables, md, lane_counts, base):
    """A synthetic init bank whose busiest column-0 model has a total
    just under 2^19, so that the lanes where it occurs often enough
    would rescale (flagged) and the others code as usual."""
    cards = np.asarray(tables.model_card, dtype=np.int64)
    offs = np.asarray(tables.model_off, dtype=np.int64)
    col0 = md[0, base:].astype(np.int64)
    ids, freq = np.unique(col0[cards[col0] > 1], return_counts=True)
    m = int(ids[np.argmax(freq)])
    lane_off = np.concatenate([[0], np.cumsum(lane_counts)])
    occ = np.array([(col0[lane_off[w]:lane_off[w + 1]] == m).sum()
                    for w in range(len(lane_counts))])
    k = int(np.sort(occ)[len(occ) // 2])
    blob = np.concatenate([np.ones(int(offs[-1]), dtype=np.uint32),
                           cards.astype(np.uint32)])
    total = ARITH_R - 8 * k
    blob[offs[m]] = total - (cards[m] - 1)
    blob[int(offs[-1]) + m] = total
    return blob, occ > k


def test_encode_lanes_reference_flags_like_jax(coder):
    n, cols = 1200, 6
    tables, md, qs = _streams(n, cols, seed=21)
    lane_counts = _lanes(n, 0, 100)
    bank, expect = _flagging_bank(tables, md, lane_counts, 0)
    assert expect.any() and not expect.all()
    want = _jax(tables, bank, md, qs, lane_counts, 0)
    got = _port(tables, bank, md, qs, lane_counts, 0)
    assert np.array_equal(got[1], expect)
    _assert_same(want, got)


def test_encode_lanes_reference_matches_host_coder():
    """Every lane's payload equals the host C++ coder's for that shard."""
    n, cols = 900, 10
    tables, md, qs = _streams(n, cols, seed=5, ratio=0.9)
    base = 120
    bank = rt.bank_from_stream(tables, md[:, :base], qs[:, :base], None,
                               base)
    lane_counts = _lanes(n, base, 200)
    pays, flags = _port(tables, bank, md, qs, lane_counts, base)
    assert not flags.any()
    lo = base
    for w, cnt in enumerate(lane_counts):
        want = rt.encode_precomputed_colmajor(
            tables, np.ascontiguousarray(md[:, lo:lo + cnt]),
            np.ascontiguousarray(qs[:, lo:lo + cnt]), None, cnt,
            init_bank=bank)
        assert pays[w] == want, f"lane {w}"
        lo += cnt


def _clustered(n, cols, n_cl, seed, base):
    """Tables of n_cl clusters, host-quantized (mid, qs) of every line,
    the cluster ids, and the bank primed by the first `base` lines."""
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    clusters = rng.integers(0, n_cl, size=n).astype(np.uint8)
    c0, cond = rt.stats_host(data, clusters, n_cl)
    tables = rt.Design(c0, cond, MODE_RATIO, 0.5,
                       make_matrix(DISTORTION_MSE)).tables()
    ws = WellState.debug()
    words = np.asarray(ws.state, dtype=np.uint32)[
        [(ws.n + i) & 31 for i in range(32)]]
    md, qs, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data.T), clusters, words)
    bank = (rt.bank_from_stream(tables, md[:, :base], qs[:, :base],
                                clusters[:base], base) if base else None)
    return tables, md, qs, clusters, bank


def _triples(plan, clusters, lane_counts, base):
    """The cluster-id segment's (W, L, 3) triples, as qvz_tpu's encode
    builds them (pad steps (0, 1, 1))."""
    ct = np.zeros((len(lane_counts), max(lane_counts), 3), dtype=np.uint32)
    ct[:, :, 1:] = 1
    lo = base
    for w, cnt in enumerate(lane_counts):
        ct[w, :cnt] = rt.replay_model(plan.cluster_init_counts,
                                      plan.cluster_init_total,
                                      clusters[lo:lo + cnt])
        lo += cnt
    return ct


@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_cluster_segment_matches_jax_and_host(coder, prime):
    n, cols, n_cl = 1003, 7, 3
    base = 100 if prime else 0
    tables, md, qs, clusters, bank = _clustered(n, cols, n_cl, 31, base)
    lane_counts = _lanes(n, base, 228)
    assert lane_counts[-1] < lane_counts[0]      # ragged last lane
    plan, jplan = cd.LanePlan(tables, bank), jcd.LanePlan(tables, bank)
    ct = _triples(plan, clusters, lane_counts, base)
    want = jcd.encode_lanes_raw(
        jplan, jnp.asarray(md.astype(np.int32)),
        jnp.asarray(qs.astype(np.int32)), lane_counts, base, ct)
    got = cd.encode_lanes_raw(
        cd.plan_to_torch(plan, "cpu"), torch.from_numpy(md.astype(np.int32)),
        torch.from_numpy(qs.astype(np.int32)), lane_counts, base, ct)
    assert not got[1].any()
    _assert_same(want, got)
    lo = base
    for w, cnt in enumerate(lane_counts):
        host = rt.encode_precomputed_colmajor(
            tables, np.ascontiguousarray(md[:, lo:lo + cnt]),
            np.ascontiguousarray(qs[:, lo:lo + cnt]), clusters[lo:lo + cnt],
            cnt, init_bank=bank)
        assert got[0][w] == host, f"lane {w}"
        lo += cnt


@pytest.mark.parametrize("prime", [True, False], ids=["bank", "ones"])
def test_cluster_plan_matches_jax(prime):
    tables, md, qs, clusters, bank = _clustered(600, 6, 4, 8,
                                                80 if prime else 0)
    a, b = jcd.LanePlan(tables, bank), cd.LanePlan(tables, bank)
    assert np.array_equal(a.totals, b.totals)
    assert np.array_equal(a.cluster_init_counts, b.cluster_init_counts)
    assert a.cluster_init_total == b.cluster_init_total
    assert len(b.cluster_init_counts) == 4
    assert b.cluster_init_total == b.cluster_init_counts.sum()
    for key in ("init_counts_cols", "slot_base", "cards", "col_slots"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key


def test_cluster_triples_are_checked():
    tables, md, qs, clusters, _ = _clustered(300, 4, 2, 3, 0)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, None), "cpu")
    m = torch.from_numpy(md.astype(np.int32))
    q = torch.from_numpy(qs.astype(np.int32))
    with pytest.raises(ValueError, match="cluster_triples"):
        cd.code_lanes(plan_t, m, q, [150, 150], 0,
                      np.zeros((2, 100, 3), dtype=np.uint32))
    with pytest.raises(ValueError, match="cluster_triples"):
        cd.code_lanes(plan_t, m, q, [150, 150], 0,
                      np.zeros((2, 150, 3), dtype=np.int64))


@pytest.mark.parametrize("prime", [True, False], ids=["bank", "ones"])
def test_lane_plan_matches_jax(prime):
    tables, md, qs = _streams(400, 7, seed=2)
    bank = (rt.bank_from_stream(tables, md[:, :50], qs[:, :50], None, 50)
            if prime else None)
    a, b = jcd.LanePlan(tables, bank), cd.LanePlan(tables, bank)
    assert a.S == b.S and a.columns == b.columns
    for key in ("init_counts_cols", "slot_base", "cards", "col_slots"):
        assert np.array_equal(getattr(a, key), getattr(b, key)), key
    # the per-model total K2 sums equals the bank's stored total
    for c in range(b.columns):
        for m in np.unique(a.mkey[c][a.mkey[c] >= 0]):
            sb, card = b.slot_base[m], b.cards[m]
            assert b.init_counts_cols[c, sb:sb + card].sum() == a.totals[m]


def test_finish_payload_matches_jax():
    rng = np.random.default_rng(0)
    for case in range(200):
        nw = int(rng.integers(0, 6))
        words = rng.integers(0, 2**32, size=nw, dtype=np.uint64).astype(
            np.uint32)
        cnt = int(rng.integers(0, 32))
        buf = int(rng.integers(0, 2**cnt)) if cnt else 0
        s3 = int(rng.integers(0, 40))
        l = int(rng.integers(0, 1 << 22))
        if case < 8:                  # bit count a multiple of 8
            s3 = (8 - (cnt + 22) % 8) % 8 + 8 * (case % 2)
        args = (words, l, s3, buf, cnt)
        assert cd.finish_payload(*args) == jcd.finish_payload(*args)


def test_code_lanes_rejects_bad_inputs():
    tables, md, qs = _streams(300, 4, seed=3)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, None), "cpu")
    m = torch.from_numpy(md.astype(np.int32))
    q = torch.from_numpy(qs.astype(np.int32))
    with pytest.raises(TypeError):
        cd.code_lanes(plan_t, m.long(), q, [300], 0)
    with pytest.raises(ValueError):
        cd.code_lanes(plan_t, m, q, [200, 200], 0)
    with pytest.raises(ValueError):
        cd.code_lanes(plan_t, m[:2], q[:2], [300], 0)


@pytest.mark.cuda
def test_lane_coder_kernel_matches_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    tables, md, qs = _streams(1200, 6, seed=21)
    lane_counts = _lanes(1200, 0, 100)
    bank, _ = _flagging_bank(tables, md, lane_counts, 0)
    want = _port(tables, bank, md, qs, lane_counts, 0)
    got = cd.encode_lanes_raw(
        cd.plan_to_torch(cd.LanePlan(tables, bank), "cuda"),
        torch.from_numpy(md.astype(np.int32)).cuda(),
        torch.from_numpy(qs.astype(np.int32)).cuda(), lane_counts, 0)
    _assert_same(want, got)


@pytest.mark.cuda
def test_lane_coder_kernel_codes_the_cluster_segment():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    tables, md, qs, clusters, bank = _clustered(1003, 7, 3, 31, 100)
    lane_counts = _lanes(1003, 100, 228)
    plan = cd.LanePlan(tables, bank)
    ct = _triples(plan, clusters, lane_counts, 100)
    m = torch.from_numpy(md.astype(np.int32))
    q = torch.from_numpy(qs.astype(np.int32))
    want = cd.encode_lanes_raw(cd.plan_to_torch(plan, "cpu"), m, q,
                               lane_counts, 100, ct)
    got = cd.encode_lanes_raw(cd.plan_to_torch(plan, "cuda"), m.cuda(),
                              q.cuda(), lane_counts, 100, ct)
    _assert_same(want, got)
