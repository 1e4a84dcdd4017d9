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


def _assert_host(tables, bank, md, qs, clusters, lane_counts, base, got):
    """No lane flagged, and every lane's payload equal to the host C++
    coder's for its shard."""
    pays, flags = got
    assert not np.asarray(flags).any()
    lo = base
    for w, cnt in enumerate(lane_counts):
        assert pays[w] == rt.encode_precomputed_colmajor(
            tables, np.ascontiguousarray(md[:, lo:lo + cnt]),
            np.ascontiguousarray(qs[:, lo:lo + cnt]),
            None if clusters is None else clusters[lo:lo + cnt], cnt,
            init_bank=bank), f"lane {w}"
        lo += cnt


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
    rescale (qvz_tpu flags them) and the others do not."""
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
    """qvz_tpu flags the lanes that reach a rescale; the port codes them,
    byte-equal to the host coder, and equals qvz_tpu on the others."""
    n, cols = 1200, 6
    tables, md, qs = _streams(n, cols, seed=21)
    lane_counts = _lanes(n, 0, 100)
    bank, expect = _flagging_bank(tables, md, lane_counts, 0)
    assert expect.any() and not expect.all()
    want = _jax(tables, bank, md, qs, lane_counts, 0)
    got = _port(tables, bank, md, qs, lane_counts, 0)
    assert np.array_equal(np.asarray(want[1], dtype=bool), expect)
    _assert_host(tables, bank, md, qs, None, lane_counts, 0, got)
    for w in np.flatnonzero(~expect):
        assert got[0][w] == want[0][w], f"lane {w}"


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
        torch.from_numpy(qs.astype(np.int32)), lane_counts, base,
        torch.from_numpy(clusters))
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
    """The lanes' cluster ids, from which K2s makes the segment's triples,
    are (N,) uint8, one a line of the quantize outputs, and a plan of one
    cluster has no segment."""
    tables, md, qs, clusters, _ = _clustered(300, 4, 2, 3, 0)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, None), "cpu")
    m = torch.from_numpy(md.astype(np.int32))
    q = torch.from_numpy(qs.astype(np.int32))
    ids = torch.from_numpy(clusters)
    with pytest.raises(ValueError, match="clusters"):
        cd.code_lanes(plan_t, m, q, [150, 150], 0, ids[:200])
    with pytest.raises(ValueError, match="clusters"):
        cd.code_lanes(plan_t, m, q, [150, 150], 0, ids.long())
    with pytest.raises(ValueError, match="clusters"):
        cd.segment_triples(plan_t, ids[:250], [150, 150], 0)
    t1, md1, qs1 = _streams(300, 4, seed=3)
    with pytest.raises(ValueError, match="one cluster"):
        cd.segment_triples(cd.plan_to_torch(cd.LanePlan(t1, None), "cpu"),
                           ids, [150, 150], 0)


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
    ids = torch.from_numpy(clusters)
    m = torch.from_numpy(md.astype(np.int32))
    q = torch.from_numpy(qs.astype(np.int32))
    want = cd.encode_lanes_raw(cd.plan_to_torch(plan, "cpu"), m, q,
                               lane_counts, 100, ids)
    got = cd.encode_lanes_raw(cd.plan_to_torch(plan, "cuda"), m.cuda(),
                              q.cuda(), lane_counts, 100, ids.cuda())
    _assert_same(want, got)


# ---------------------------------------------------------------------------
# K2's two parts: the triples (K2a) and the chain (K2b), their plain
# versions, the column chunks and K2a's layouts.


def _replay_triples(tables, bank, md, qs, lane_counts, base, c0, c1):
    """The host coder's counting replayed in numpy, lane by lane and column
    by column from the bank's counts: each step's packed (cum_lo, cum_hi,
    total), step-major, and each lane's count of rescales (every count c
    becomes (c >> 1) + 1 where the total passes 2^19)."""
    cards = np.asarray(tables.model_card, dtype=np.int64)
    moff = np.asarray(tables.model_off, dtype=np.int64)
    bank0 = (np.ones(int(moff[-1]), dtype=np.int64) if bank is None
             else np.asarray(bank[: int(moff[-1])], dtype=np.int64))
    W, L = len(lane_counts), max(lane_counts)
    out = np.zeros(((c1 - c0) * L, W), dtype=np.int64)
    flags = np.zeros(W, dtype=np.int64)
    lo = base
    for w, cnt in enumerate(lane_counts):
        for c in range(c0, c1):
            counts = bank0.copy()
            for j in range(cnt):
                m, x = int(md[c, lo + j]), int(qs[c, lo + j])
                if m <= 0 or cards[m] <= 1:
                    continue
                seg = counts[moff[m]: moff[m] + cards[m]]
                total = int(seg.sum())
                cum_lo = int(seg[:x].sum())
                cum_hi = cum_lo + int(seg[x])
                out[(c - c0) * L + j, w] = cum_lo | cum_hi << 20 | total << 40
                seg[x] += 8
                if total + 8 > ARITH_R:
                    flags[w] += 1
                    seg[:] = (seg >> 1) + 1
        lo += cnt
    return out, flags


@pytest.mark.parametrize("case", ["prime", "flagging"])
@pytest.mark.parametrize("c0,c1", [(0, 6), (2, 5)], ids=["all", "chunk"])
def test_triples_reference_matches_numpy_replay(case, c0, c1):
    n, cols = 700, 6
    tables, md, qs = _streams(n, cols, seed=23)
    lane_counts = _lanes(n, 0, 150)
    if case == "prime":
        bank = rt.bank_from_stream(tables, md[:, :90], qs[:, :90], None, 90)
    else:
        bank, _ = _flagging_bank(tables, md, lane_counts, 0)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, bank), "cpu")
    trip = cd.triples_reference(
        plan_t, torch.from_numpy(md.astype(np.int32)),
        torch.from_numpy(qs.astype(np.int32)), lane_counts, 0, c0, c1)
    want, rescaled = _replay_triples(tables, bank, md, qs, lane_counts, 0,
                                     c0, c1)
    assert np.array_equal(trip.numpy(), want)
    assert rescaled.any() == (case == "flagging" and c0 == 0)
    assert (want != 0).mean() > 0.5


@pytest.mark.parametrize("segment", [False, True], ids=["c1", "segment"])
def test_chain_reference_matches_pass2(segment):
    """The chain over given triples against qvz_tpu's XLA interval scan
    over the same triples (a step that codes nothing as its (0, 1, 1))."""
    n, cols = 1003, 6
    if segment:
        tables, md, qs, clusters, bank = _clustered(n, cols, 3, 17, 0)
    else:
        (tables, md, qs), bank = _streams(n, cols, seed=13), None
    lane_counts = _lanes(n, 0, 228)
    plan = cd.LanePlan(tables, bank)
    trip = cd.triples_reference(
        cd.plan_to_torch(plan, "cpu"), torch.from_numpy(md.astype(np.int32)),
        torch.from_numpy(qs.astype(np.int32)), lane_counts, 0, 0, cols)
    ncols = cols
    if segment:
        seg = cd.segment_triples(cd.plan_to_torch(plan, "cpu"),
                                 torch.from_numpy(clusters), lane_counts, 0)
        trip, ncols = torch.cat([seg, trip]), cols + 1
    words, n_words, carry = cd.chain_reference(trip, ncols, lane_counts)

    t = trip.numpy()
    live = (t >> 40) != 0
    lo = np.where(live, t & 0xFFFFF, 0).astype(np.uint32)
    hi = np.where(live, (t >> 20) & 0xFFFFF, 1).astype(np.uint32)
    tot = np.where(live, t >> 40, 1).astype(np.uint32)
    jcarry, (w0, w1, f0, f1) = jcd._pass2(jnp.asarray(lo), jnp.asarray(hi),
                                          jnp.asarray(tot))
    jwords, jcount = jcd._compact(w0, w1, f0, f1, 2 * t.shape[0])
    jwords, jcount = np.asarray(jwords), np.asarray(jcount)
    assert np.array_equal(n_words.numpy(), jcount)
    for w in range(len(lane_counts)):
        assert np.array_equal(words[w, : n_words[w]].numpy().view(np.uint32),
                              jwords[: jcount[w], w]), f"lane {w}"
    for k in range(6):
        assert np.array_equal(carry[k].numpy(),
                              np.asarray(jcarry[k]).astype(np.int64)), k


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("segment", [False, True], ids=["c1", "segment"])
def test_column_chunks_match_jax(coder, monkeypatch, chunks, segment):
    """The composition over 1, 2 and 3 chunks of columns: payloads and
    flags equal qvz_tpu's and the host coder's, and the raw output equal
    to the one-chunk run."""
    n, cols, base = 1003, 6, 100
    if segment:
        tables, md, qs, clusters, bank = _clustered(n, cols, 3, 29, base)
    else:
        tables, md, qs = _streams(n, cols, seed=37)
        clusters = None
        bank = rt.bank_from_stream(tables, md[:, :base], qs[:, :base], None,
                                   base)
    lane_counts = _lanes(n, base, 228)
    W, L = len(lane_counts), max(lane_counts)
    plan = cd.LanePlan(tables, bank)
    ct = _triples(plan, clusters, lane_counts, base) if segment else None
    args = (cd.plan_to_torch(plan, "cpu"),
            torch.from_numpy(md.astype(np.int32)),
            torch.from_numpy(qs.astype(np.int32)), lane_counts, base,
            torch.from_numpy(clusters) if segment else None)
    one = cd.code_lanes(*args)
    monkeypatch.setattr(cd, "TRIPLE_BYTES", 8 * W * L * -(-cols // chunks))
    assert -(-cols // cd.chunk_columns(cols, W, L)) == chunks
    raw = cd.code_lanes(*args)
    for a, b in zip(raw, one):
        assert torch.equal(a, b)
    got = cd.encode_lanes_raw(*args)
    assert not got[1].any()
    want = jcd.encode_lanes_raw(
        jcd.LanePlan(tables, bank), jnp.asarray(md.astype(np.int32)),
        jnp.asarray(qs.astype(np.int32)), lane_counts, base, ct)
    _assert_same(want, got)
    lo = base
    for w, cnt in enumerate(lane_counts):
        assert got[0][w] == rt.encode_precomputed_colmajor(
            tables, np.ascontiguousarray(md[:, lo:lo + cnt]),
            np.ascontiguousarray(qs[:, lo:lo + cnt]),
            clusters[lo:lo + cnt] if segment else None, cnt,
            init_bank=bank), f"lane {w}"
        lo += cnt


def test_flags_over_column_chunks_like_jax(coder, monkeypatch):
    """The rescaling lanes over chunks of columns (each chunk's records
    sized with its triples): qvz_tpu flags them, the port codes them
    byte-equal to the host coder."""
    n, cols = 1200, 6
    tables, md, qs = _streams(n, cols, seed=21)
    lane_counts = _lanes(n, 0, 100)
    bank, expect = _flagging_bank(tables, md, lane_counts, 0)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, bank), "cpu")
    rec = cd.risk_tables(plan_t, 100)["rec_max"]
    assert rec > 0
    monkeypatch.setattr(cd, "TRIPLE_BYTES",
                        8 * len(lane_counts) * (100 + rec) * 2)
    assert cd.chunk_columns(cols, len(lane_counts), 100, rec) == 2
    want = _jax(tables, bank, md, qs, lane_counts, 0)
    got = _port(tables, bank, md, qs, lane_counts, 0)
    assert np.array_equal(np.asarray(want[1], dtype=bool), expect)
    _assert_host(tables, bank, md, qs, None, lane_counts, 0, got)


@pytest.mark.parametrize("S,models,lmax,lpw,want", [
    (1004, 130, 240, 4, (4, 26, 64, 78)),      # -c 1 at 1M x 100
    (2361, 366, 240, 4, (4, 32, 64, 32)),      # -c 3 at 1M x 100
    (1004, 130, 24, 32, (28, 28, 24, 84)),     # short lanes, one warp
    (15000, 7000, 260, 4, (1, 1, 64, 1)),      # one lane a block
])
def test_triples_shape_fits(S, models, lmax, lpw, want):
    shape = cd.triples_shape(S, models, lmax, 232_448, 233_472, lpw)
    assert (shape["lpw"], shape["lpb"], shape["lt"],
            shape["lanes_per_sm"]) == want
    assert shape["layout"] == 0
    assert shape["smem"] + 384 <= 232_448
    assert shape["s_pad"] % 8 == 0 and shape["m_pad"] % 8 == 0


def test_triples_shape_refuses():
    """A forced layout that cannot hold one lane, and a lanes-a-warp that
    is not a power of two, raise; nothing else does."""
    with pytest.raises(ValueError, match="layout 0 .* shared memory"):
        cd.triples_shape(17_100, 7_174, 260, 232_448, 233_472, layout=0)
    with pytest.raises(ValueError, match="layout 1 .* shared memory"):
        cd.triples_shape(200_000, 400, 260, 232_448, 233_472, layout=1)
    with pytest.raises(ValueError, match="power of two"):
        cd.triples_shape(1004, 130, 240, 232_448, 233_472, 3)


@pytest.mark.parametrize("S,models,lmax,want", [
    (17_100, 7_174, 260, (4, 4, 64, 4, 1)),        # -c 150 at 200k x 20
    (200_000, 400, 260, (4, 32, 64, 256, 2)),      # one lane's uses too big
    (10**6, 10**5, 150_000, (4, 32, 64, 256, 2)),  # any plan has a layout
])
def test_triples_shape_layouts(S, models, lmax, want):
    """Where the column's tables and one lane's uses do not fit a block
    together, K2a reads the tables from device memory (layout 1); where
    one lane's uses alone do not fit, it keeps them there too (layout 2).
    Every plan has a layout, so K2a takes every plan."""
    shape = cd.triples_shape(S, models, lmax, 232_448, 233_472)
    assert (shape["lpw"], shape["lpb"], shape["lt"], shape["lanes_per_sm"],
            shape["layout"]) == want
    assert shape["smem"] + 384 <= 232_448
    assert cd.triples_shape(S, models, lmax, 232_448, 233_472,
                            layout=shape["layout"]) == shape


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [0, 1, 2])
def test_triples_kernel_layouts_match_plain(layout):
    """K2a equals its plain version in each of its layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2a has no CPU mode)")
    tables, md, qs, clusters, bank = _clustered(1003, 7, 3, 31, 100)
    lane_counts = _lanes(1003, 100, 228)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, bank), "cuda")
    m = torch.from_numpy(md.astype(np.int32)).cuda()
    q = torch.from_numpy(qs.astype(np.int32)).cuda()
    got = cd.triples(plan_t, m, q, lane_counts, 100, 1, 7, layout=layout)
    want = cd.triples_reference(plan_t, m, q, lane_counts, 100, 1, 7)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_triples_and_chain_kernels_match_plain(monkeypatch):
    """K2a and K2b each equal their plain version on the card, over two
    chunks of columns with the cluster-id segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2a and K2b have no CPU mode)")
    tables, md, qs, clusters, bank = _clustered(1003, 7, 3, 31, 100)
    lane_counts = _lanes(1003, 100, 228)
    plan = cd.LanePlan(tables, bank)
    ids = torch.from_numpy(clusters).cuda()
    plan_t = cd.plan_to_torch(plan, "cuda")
    m = torch.from_numpy(md.astype(np.int32)).cuda()
    q = torch.from_numpy(qs.astype(np.int32)).cuda()
    trip = cd.triples(plan_t, m, q, lane_counts, 100, 2, 7)
    want = cd.triples_reference(plan_t, m, q, lane_counts, 100, 2, 7)
    assert torch.equal(trip, want)
    seg = cd.segment_triples(plan_t, ids, lane_counts, 100)
    raw = cd.chain(seg, 1, lane_counts,
                   cd.start_raw(len(lane_counts), "cuda", 4096))
    want = cd.chain_reference(seg, 1, lane_counts)
    assert torch.equal(raw[1], want[1]) and torch.equal(raw[2], want[2])
    monkeypatch.setattr(cd, "TRIPLE_BYTES", 8 * len(lane_counts) * 228 * 4)
    got = cd.encode_lanes_raw(plan_t, m, q, lane_counts, 100, ids)
    _assert_same(cd.encode_lanes_raw(cd.plan_to_torch(plan, "cpu"), m.cpu(),
                                     q.cpu(), lane_counts, 100, ids.cpu()),
                 got)


# ---------------------------------------------------------------------------
# The exact rescale: lanes whose models pass 2^19 are coded, not flagged.


def _near_limit(tables, bank, md, col, short):
    """`bank` (None: counts ones, totals the cardinalities) with the
    busiest live model of column `col` started `short` short of 2^19,
    its first count raised; returns (bank, model)."""
    cards = np.asarray(tables.model_card, dtype=np.int64)
    moff = np.asarray(tables.model_off, dtype=np.int64)
    blob = (np.concatenate([np.ones(int(moff[-1]), dtype=np.uint32),
                            cards.astype(np.uint32)]) if bank is None
            else np.array(bank, dtype=np.uint32))
    ids, freq = np.unique(md[col].astype(np.int64), return_counts=True)
    live = cards[ids] > 1
    m = int(ids[live][np.argmax(freq[live])])
    total = ARITH_R - short
    blob[moff[m]] += total - blob[int(moff[-1]) + m]
    blob[int(moff[-1]) + m] = total
    return blob, m


def test_triples_rescale_twice_in_a_lane():
    """One lane whose every step uses one model, started 16 short of
    2^19: it rescales at its third use and again about 32,768 uses later.
    The plain K2a's triples equal the host's counting replayed in numpy."""
    tables, md, qs = _streams(400, 3, seed=41)
    cards = np.asarray(tables.model_card, dtype=np.int64)
    bank, m = _near_limit(tables, None, md, 1, 16)
    L = 33_000
    rng = np.random.default_rng(41)
    md1 = np.zeros((3, L), dtype=np.uint32)
    qs1 = np.zeros((3, L), dtype=np.uint8)
    md1[1] = m
    qs1[1] = rng.integers(0, cards[m], L)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, bank), "cpu")
    trip = cd.triples_reference(
        plan_t, torch.from_numpy(md1.astype(np.int32)),
        torch.from_numpy(qs1.astype(np.int32)), [L], 0, 1, 2)
    want, rescales = _replay_triples(tables, bank, md1, qs1, [L], 0, 1, 2)
    assert rescales[0] == 2
    assert np.array_equal(trip.numpy(), want)
    assert cd.risk_tables(plan_t, L)["models"] >= 1


def test_risk_tables_mark_the_models_that_can_rescale():
    """A plan whose models all stay below 2^19 in any lane has no model at
    risk and no record; one with a model near the limit marks it (and
    every model whose total + 8 x the longest lane passes 2^19), with a
    record of its total and each slot's prefix and count."""
    tables, md, qs = _streams(700, 6, seed=23)
    none = cd.risk_tables(cd.plan_to_torch(cd.LanePlan(tables, None),
                                           "cpu"), 150)
    assert none["models"] == 0 and none["rec_max"] == 0
    assert (none["rbase"] == -1).all() and none["rsrc"].numel() == 0
    assert none["roff_h"].tolist() == [0] * 7
    assert cd.chunk_columns(6, 5, 150, none["rec_max"]) == \
        cd.chunk_columns(6, 5, 150)

    bank, m = _near_limit(tables, None, md, 2, 800)
    plan = cd.LanePlan(tables, bank)
    plan_t = cd.plan_to_torch(plan, "cpu")
    assert cd.risk_tables(plan_t, 99)["models"] == 0     # 8 x 99 < 800
    risk = cd.risk_tables(plan_t, 150)
    assert cd.risk_tables(plan_t, 150) is risk            # cached
    mt, cmo = plan.mtab, plan.col_model_off
    card, tot = mt[:, 1] >> 20, mt[:, 1] & ((1 << 20) - 1)
    want = (card > 1) & (tot + 8 * 150 > ARITH_R)
    assert risk["models"] == int(want.sum()) >= 1
    g = int(cmo[2] + plan.mloc[m])
    assert want[g] and (risk["rbase"].numpy() >= 0).tolist() == want.tolist()
    roff, rsrc = risk["roff_h"], risk["rsrc"].numpy()
    assert roff[-1] == len(rsrc) == int((card[want] + 1).sum())
    for gi in np.flatnonzero(want):
        c = int(np.searchsorted(cmo, gi, side="right") - 1)
        at = int(roff[c] + risk["rbase"][gi])
        assert rsrc[at] == -1 - (gi - cmo[c])
        assert rsrc[at + 1:at + 1 + card[gi]].tolist() == list(
            range(mt[gi, 0], mt[gi, 0] + card[gi]))
    assert risk["rec_max"] == int(np.diff(roff).max())
    assert cd.chunk_columns(6, 5, 150, risk["rec_max"]) <= \
        cd.chunk_columns(6, 5, 150)
    # the plain coder does not need the records: the same lanes code to
    # the host coder's bytes
    lane_counts = _lanes(700, 0, 150)
    _assert_host(tables, bank, md, qs, None, lane_counts, 0,
                 _port(tables, bank, md, qs, lane_counts, 0))


@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_cluster_segment_rescale_ragged(prime):
    """-c 3 with the cluster-id segment, ragged lanes, a bank (primed or
    not) whose busiest models of columns 0 and 3 start just short of
    2^19: qvz_tpu flags the lanes that reach them, the port codes every
    lane byte-equal to the host coder."""
    n, cols, base = 1003, 7, 100 if prime else 0
    tables, md, qs, clusters, bank = _clustered(n, cols, 3, 43, base)
    bank, _ = _near_limit(tables, bank, md[:, base:], 0, 40)
    bank, _ = _near_limit(tables, bank, md[:, base:], 3, 400)
    lane_counts = _lanes(n, base, 228)
    assert lane_counts[-1] < lane_counts[0]
    plan = cd.LanePlan(tables, bank)
    ct = _triples(plan, clusters, lane_counts, base)
    got = cd.encode_lanes_raw(
        cd.plan_to_torch(plan, "cpu"), torch.from_numpy(md.astype(np.int32)),
        torch.from_numpy(qs.astype(np.int32)), lane_counts, base,
        torch.from_numpy(clusters))
    want = jcd.encode_lanes_raw(
        jcd.LanePlan(tables, bank), jnp.asarray(md.astype(np.int32)),
        jnp.asarray(qs.astype(np.int32)), lane_counts, base, ct)
    assert np.asarray(want[1]).any()
    _assert_host(tables, bank, md, qs, clusters, lane_counts, base, got)
    for w in np.flatnonzero(~np.asarray(want[1], dtype=bool)):
        assert got[0][w] == want[0][w], f"lane {w}"


def _bit_writer(pending: str, first: int, s3: int) -> str:
    """The host's bit writer at one E1 step of k1 = 1: the pending bits,
    the first bit, then s3 complements of it."""
    return pending + str(first) + str(1 - first) * s3


@pytest.mark.parametrize("s3", [31, 32, 53, 62, 63, 100])
def test_chain_emits_pending_runs(s3):
    """The plain K2b at a pending run of s3 bits: from the full interval
    with 5 bits pending, one step onto the lower half (first bit 0, then
    s3 1s) or the upper half (1, then 0s) packs the bit writer's bits."""
    raw = cd.start_raw(2, "cpu")
    raw[2][2], raw[2][3], raw[2][4] = s3, 0b10110, 5
    upper = torch.tensor([0, 1])
    trip = cd.pack_triples(upper, upper + 1, torch.full((2,), 2))[None]
    words, n_words, carry = cd.chain_reference(trip, 1, [1, 1], raw)
    for w in range(2):
        bits = _bit_writer("10110", w, s3)
        nw = len(bits) // 32
        rest = bits[32 * nw:]
        assert int(n_words[w]) == nw
        assert [int(words[w, k]) & 0xFFFFFFFF for k in range(nw)] == [
            int(bits[32 * k:32 * k + 32], 2) for k in range(nw)]
        assert int(carry[3, w]) == int(rest or "0", 2)
        assert int(carry[4, w]) == len(rest)
        assert int(carry[2, w]) == 0 and int(carry[5, w]) == 0
        assert (int(carry[0, w]), int(carry[1, w])) == (0, cd.FULL)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [0, 1, 2])
def test_rescale_kernels_match_plain(layout):
    """K2a with the records of models at risk, and K2b, equal their plain
    versions on the card in each layout; the payloads are the host
    coder's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    n, cols, base = 1003, 7, 100
    tables, md, qs, clusters, bank = _clustered(n, cols, 3, 43, base)
    bank, _ = _near_limit(tables, bank, md[:, base:], 0, 40)
    lane_counts = _lanes(n, base, 228)
    plan = cd.LanePlan(tables, bank)
    m = torch.from_numpy(md.astype(np.int32))
    q = torch.from_numpy(qs.astype(np.int32))
    got = cd.triples(cd.plan_to_torch(plan, "cuda"), m.cuda(), q.cuda(),
                     lane_counts, base, 0, cols, layout=layout)
    want = cd.triples_reference(cd.plan_to_torch(plan, "cpu"), m, q,
                                lane_counts, base, 0, cols)
    assert torch.equal(got.cpu(), want)
    _assert_host(tables, bank, md, qs, clusters, lane_counts, base,
                 cd.encode_lanes_raw(cd.plan_to_torch(plan, "cuda"),
                                     m.cuda(), q.cuda(), lane_counts, base,
                                     torch.from_numpy(clusters).cuda()))


# ---------------------------------------------------------------------------
# K2s: the cluster-id segment's triples from the lanes' ids on the device.


def _replayed(plan, clusters, lane_counts, base):
    """qvz_tpu's rt.replay_model over each lane's ids, packed as K2b's
    step-major (L, W) triples, 0 past a ragged lane's end."""
    W, L = len(lane_counts), max(lane_counts)
    want = np.zeros((L, W), dtype=np.int64)
    lo = base
    for w, cnt in enumerate(lane_counts):
        t = rt.replay_model(plan.cluster_init_counts,
                            plan.cluster_init_total,
                            clusters[lo:lo + cnt]).astype(np.int64)
        want[:cnt, w] = t[:, 0] | (t[:, 1] << 20) | (t[:, 2] << 40)
        lo += cnt
    return want


@pytest.mark.parametrize("n_cl", [2, 3])
@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_segment_triples_reference_matches_replay_model(n_cl, prime):
    """K2s's plain version equals qvz_tpu's host replay of the cluster-id
    model on every lane, ragged lanes and a primed bank included."""
    n, cols = 1003, 6
    base = 100 if prime else 0
    tables, md, qs, clusters, bank = _clustered(n, cols, n_cl, 50 + n_cl,
                                                base)
    lane_counts = _lanes(n, base, 228)
    assert lane_counts[-1] < lane_counts[0]
    plan = cd.LanePlan(tables, bank)
    got = cd.segment_triples_reference(cd.plan_to_torch(plan, "cpu"),
                                       torch.from_numpy(clusters),
                                       lane_counts, base)
    assert np.array_equal(got.numpy(),
                          _replayed(plan, clusters, lane_counts, base))


def _model0_near_limit(tables, bank, short):
    """`bank` (None: counts ones, totals the cardinalities) with the
    cluster-id model (model 0) started `short` short of 2^19, its first
    count raised."""
    cards = np.asarray(tables.model_card, dtype=np.int64)
    moff = np.asarray(tables.model_off, dtype=np.int64)
    blob = (np.concatenate([np.ones(int(moff[-1]), dtype=np.uint32),
                            cards.astype(np.uint32)]) if bank is None
            else np.array(bank, dtype=np.uint32))
    total = ARITH_R - short
    blob[0] += total - blob[int(moff[-1])]
    blob[int(moff[-1])] = total
    return blob


def test_segment_triples_reference_rescales_twice():
    """Model 0 started 24 short of 2^19 in lanes of 33,000 ids: it rescales
    at a lane's fourth id and again about 32,768 ids later; K2s's plain
    version equals the host's replay through both, and the lanes code to
    the host coder's payloads."""
    n, cols, W = 66_000, 1, 2
    tables, md, qs, clusters, _ = _clustered(n, cols, 3, 61, 0)
    bank = _model0_near_limit(tables, None, 24)
    plan = cd.LanePlan(tables, bank)
    lane_counts = [33_000, 33_000]
    trip = _replayed(plan, clusters, lane_counts, 0)
    totals = trip >> 40
    rescales = (totals[1:] != totals[:-1] + 8).sum(0)
    assert (rescales >= 2).all()
    plan_t = cd.plan_to_torch(plan, "cpu")
    got = cd.segment_triples_reference(plan_t, torch.from_numpy(clusters),
                                       lane_counts, 0)
    assert np.array_equal(got.numpy(), trip)


@pytest.mark.cuda
@pytest.mark.parametrize("short", [None, 24], ids=["plain", "rescale"])
def test_segment_kernel_matches_plain(short):
    """K2s equals its plain version on the card, ragged lanes and model 0's
    rescale included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2s has no CPU mode)")
    tables, md, qs, clusters, bank = _clustered(1003, 7, 3, 31, 100)
    if short is not None:
        bank = _model0_near_limit(tables, bank, short)
    lane_counts = _lanes(1003, 100, 228)
    plan = cd.LanePlan(tables, bank)
    ids = torch.from_numpy(clusters)
    want = cd.segment_triples_reference(cd.plan_to_torch(plan, "cpu"), ids,
                                        lane_counts, 100)
    got = cd.segment_triples(cd.plan_to_torch(plan, "cuda"), ids.cuda(),
                             lane_counts, 100)
    assert torch.equal(got.cpu(), want)
