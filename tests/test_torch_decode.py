"""qvz_tpu_torch's device QVZ2 decode on the CPU (K5's plain version)
against qvz_tpu: the lane decoder against qvz_tpu.ops.decoder_device's
decode_lanes, through its XLA scan and through the Pallas kernel
decoder_pallas._dkernel in interpret mode, and the pipeline's bytes
against qvz_tpu's host decoder and its device path. Symbols, flags and
bytes are compared exactly."""

import numpy as np
import pytest
import torch

from qvz_tpu.constants import ARITH_R, DISTORTION_MSE
from qvz_tpu.format import container_v2
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops import coder_device as jcd
from qvz_tpu.ops import decoder_device as jdd
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline import decode as host_decode
from qvz_tpu.pipeline import encode as host_encode
from qvz_tpu_torch.ops import coder_device as cd
from qvz_tpu_torch.ops import decoder_device as dd
from qvz_tpu_torch.pipeline import decode as port
from qvz_tpu_torch.pipeline import encode as port_encode
from qvz_tpu_torch.pipeline import host as port_host

DIST = make_matrix(DISTORTION_MSE)


def _data(n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


def _encode(data, **kw):
    return host_encode.encode(data, DIST, well_state=WellState.debug(),
                              use_jax=False, **kw).compressed


@pytest.fixture
def small_warmup(monkeypatch):
    """Prime with a 512-line warmup shard in both packages, so a small
    input primes."""
    monkeypatch.setattr(host_encode, "PRIME_WARMUP_LINES", 512)
    monkeypatch.setattr(port_host, "PRIME_WARMUP_LINES", 512)


def _tables(comp):
    head = container_v2.parse(comp, blocks_len=None)
    tables = rt.tables_from_blocks(comp[container_v2.header_size():],
                                   head.cluster_count, head.columns)
    return container_v2.parse(comp, blocks_len=tables.consumed), tables


# ---------------------------------------------------------------------------
# Kernel level: the port's lanes against qvz_tpu's decode_lanes.


def _payloads(lanes):
    flat = lanes.pays.flat.numpy().tobytes()
    off = lanes.pays.off.numpy()
    return [flat[o:o + n] for o, n in zip(off, lanes.pays.lens)]


def _port_lanes(lanes, cols):
    """All lanes in one call of the port's decode_lanes_t (ragged lanes
    included): per-lane (L, cols) symbols, flags and final states."""
    n = lanes.draws_t.shape[1]
    out = torch.zeros((n, cols), dtype=torch.uint8)
    final = dd.decode_lanes_t(lanes.dplan_t, lanes.pays, lanes.draws_t,
                              lanes.cl, lanes.lane_counts, 0, lanes.starts,
                              out)
    offs = np.concatenate([[0], np.cumsum(lanes.lane_counts)])
    qv = [out[offs[w]:offs[w + 1]].numpy()
          for w in range(len(lanes.lane_counts))]
    return qv, final[:, 4].numpy() != 0, final.numpy()


def _jax_lanes(lanes, tables, cols):
    """qvz_tpu's decode_lanes, called once per group of equal-length
    lanes as its pipeline groups them."""
    plan = jdd.DecodePlan(jcd.LanePlan(tables, lanes.bank), tables)
    pays = _payloads(lanes)
    offs = np.concatenate([[0], np.cumsum(lanes.lane_counts)])
    draws = lanes.draws_t.numpy()
    cl = (lanes.cl.numpy() if lanes.cl is not None
          else np.zeros(draws.shape[1], dtype=np.uint8))
    starts = lanes.starts.numpy()
    W = len(lanes.lane_counts)
    qv, flags = [None] * W, np.zeros(W, dtype=bool)
    for L in sorted(set(lanes.lane_counts)):
        ws = [w for w in range(W) if lanes.lane_counts[w] == L]
        idx = np.stack([np.arange(offs[w], offs[w + 1]) for w in ws])
        q, f = jdd.decode_lanes(plan, [pays[w] for w in ws],
                                draws[:, idx], cl[idx],
                                [tuple(starts[w]) for w in ws])
        for k, w in enumerate(ws):
            qv[w], flags[w] = np.asarray(q[k]), bool(f[k])
    return qv, flags


def _rescale_bank(tables, md, lane_counts):
    """A synthetic init bank (counts ones, totals the cardinalities) in
    which a live model of column 1 starts j steps of 8 short of 2^19, j
    the fewest uses of it in any lane: a lane that uses it more than j
    times reaches the rescale, the others do not."""
    cards = np.asarray(tables.model_card, dtype=np.int64)
    moff = np.asarray(tables.model_off, dtype=np.int64)
    counts = np.ones(int(moff[-1]), dtype=np.uint32)
    totals = cards.astype(np.uint32)
    offs = np.concatenate([[0], np.cumsum(lane_counts)])
    uses = np.stack([np.bincount(md[1, offs[w]:offs[w + 1]].astype(np.int64),
                                 minlength=len(cards))
                     for w in range(len(lane_counts))])
    spread = np.where(cards > 1, uses.max(0) - uses.min(0), 0)
    m = int(spread.argmax())
    assert spread[m] > 0
    total = ARITH_R - 8 * int(uses[:, m].min())
    counts[moff[m]] = total - (cards[m] - 1)
    totals[m] = total
    return np.concatenate([counts, totals])


def _rescale_lanes():
    """Lanes coded on the host from the synthetic bank: valid streams in
    which some lanes reach the rescale."""
    data = _data(500, 6, seed=19)
    comp = _encode(data, shards=4, prime=False)
    head, tables = _tables(comp)
    states = np.stack([np.frombuffer(s.well_state, dtype="<u4")
                       for s in head.shards])
    lane_counts = [s.lines for s in head.shards]
    md = np.empty((6, 500), dtype=np.uint32)
    qs = np.empty((6, 500), dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum(lane_counts)])
    for w in range(4):
        md[:, offs[w]:offs[w + 1]], qs[:, offs[w]:offs[w + 1]], _, _ = \
            rt.quantize_colmajor(tables, np.ascontiguousarray(
                data[offs[w]:offs[w + 1]].T), None, states[w])
    bank = _rescale_bank(tables, md, lane_counts)
    pays = [rt.encode_precomputed_colmajor(
        tables, md[:, offs[w]:offs[w + 1]], qs[:, offs[w]:offs[w + 1]],
        None, lane_counts[w], init_bank=bank) for w in range(4)]
    draws = host_encode._shard_draws(states, lane_counts, 6)
    lanes = port.Lanes(
        dd.decode_plan_to_torch(dd.DecodePlan(cd.LanePlan(tables, bank),
                                              tables), "cpu"),
        dd.pack_payloads(pays, "cpu"),
        torch.from_numpy(np.ascontiguousarray(draws.T)), None, lane_counts,
        torch.tensor([dd.start_state(p) for p in pays]), bank, 0)
    host = [rt.decode_colmajor(tables, pays[w], lane_counts[w], states[w],
                               init_bank=bank)[:, :6] - 33
            for w in range(4)]
    return lanes, tables, host


def _case(name, monkeypatch):
    """(Lanes, tables, host decoder's symbols per lane or None)."""
    if name == "rescale":
        return _rescale_lanes()
    if name == "primed":
        monkeypatch.setattr(host_encode, "PRIME_WARMUP_LINES", 512)
    data, kw = {
        "c1": (_data(500, 6, seed=3), dict(shards=4)),
        "c3": (_data(500, 6, seed=4), dict(shards=4, n_clusters=3)),
        "primed": (_data(1040, 6, seed=5), dict(shards=5, prime=True)),
        "ragged": (_data(503, 6, seed=6), dict(shards=5, n_clusters=2)),
        "cols1": (_data(500, 1, seed=7), dict(shards=3)),
    }[name]
    comp = _encode(data, **{"prime": False, **kw})
    lanes = port.prepare_lanes(comp, "cpu")
    head, tables = _tables(comp)
    assert bool(head.priming) == (name == "primed")
    return lanes, tables, None


CASES = ["c1", "c3", "primed", "ragged", "cols1", "rescale"]


@pytest.mark.parametrize("path", ["xla", "interpret"])
@pytest.mark.parametrize("case", CASES)
def test_lanes_match_qvz_tpu(case, path, monkeypatch):
    """No lane flagged by the port; qv equal to qvz_tpu's on every lane it
    does not flag, and in the rescale case, where qvz_tpu flags the lanes
    that reach a rescale, every lane equal to the host decoder's."""
    if path == "interpret":
        monkeypatch.setenv("QVZ_TPU_DEC_PALLAS", "interpret")
    else:
        monkeypatch.setenv("QVZ_TPU_DEC_PALLAS", "0")
    lanes, tables, host = _case(case, monkeypatch)
    cols = lanes.draws_t.shape[0]
    got, gflags, final = _port_lanes(lanes, cols)
    want, wflags = _jax_lanes(lanes, tables, cols)
    assert not gflags.any() and (final[:, 4] == 0).all()
    for w in np.flatnonzero(~wflags):
        assert np.array_equal(got[w], want[w]), f"lane {w}"
    counts = lanes.lane_counts
    if case == "rescale":
        assert wflags.any() and not wflags.all()
        for w in range(len(counts)):
            assert np.array_equal(got[w], host[w]), f"lane {w}"
    else:
        assert not wflags.any()
    if case == "c3":
        # a prologue ends mid-byte: the lane's bit feed starts unaligned
        assert (lanes.starts[:, 3] % 8 != 0).any()
    if case == "ragged":
        assert len(set(counts)) == 2


def test_decode_lanes_contract():
    """decode_lanes keeps qvz_tpu's (qv (W, L, cols), flags) contract."""
    comp = _encode(_data(600, 5, seed=8), shards=3, n_clusters=2,
                   prime=False)
    lanes = port.prepare_lanes(comp, "cpu")
    head, tables = _tables(comp)
    assert len(set(lanes.lane_counts)) == 1
    L, W = lanes.lane_counts[0], len(lanes.lane_counts)
    draws = lanes.draws_t.numpy().reshape(5, W, L)
    cl = lanes.cl.numpy().reshape(W, L)
    states = [tuple(s) for s in lanes.starts.numpy()]
    pays = _payloads(lanes)
    qv, flags = dd.decode_lanes(dd.DecodePlan(cd.LanePlan(tables, None),
                                              tables), pays, draws, cl,
                                states, device="cpu")
    jqv, jflags = jdd.decode_lanes(
        jdd.DecodePlan(jcd.LanePlan(tables, None), tables), pays, draws, cl,
        states)
    assert qv.shape == (W, L, 5) and qv.dtype == np.uint8
    assert np.array_equal(qv, np.asarray(jqv))
    assert np.array_equal(flags, np.asarray(jflags)) and not flags.any()


def test_column_prefix_state():
    """cols_run stops after a column prefix: the prefix's rows equal the
    full run's, and the state is that of the prefix."""
    comp = _encode(_data(600, 5, seed=9), shards=3, prime=False)
    lanes = port.prepare_lanes(comp, "cpu")
    n = lanes.draws_t.shape[1]
    outs, finals = [], []
    for cols_run in (2, 5):
        out = torch.zeros((n, 6), dtype=torch.uint8)
        finals.append(dd.decode_lanes_t(
            lanes.dplan_t, lanes.pays, lanes.draws_t, lanes.cl,
            lanes.lane_counts, 0, lanes.starts, out, 33, cols_run))
        outs.append(out)
    assert torch.equal(outs[0][:, :2], outs[1][:, :2])
    assert (outs[0][:, 2:5] == 0).all() and (outs[0][:, 5] == 10).all()
    assert (finals[0][:, 3] < finals[1][:, 3]).all()
    assert (finals[1][:, 4] == 0).all()


def test_wrapper_checks_its_inputs():
    comp = _encode(_data(400, 4, seed=10), shards=2, prime=False)
    lanes = port.prepare_lanes(comp, "cpu")
    n = lanes.draws_t.shape[1]
    args = (lanes.dplan_t, lanes.pays, lanes.draws_t, lanes.cl,
            lanes.lane_counts, 0, lanes.starts)
    with pytest.raises(ValueError, match="out must be"):
        dd.decode_lanes_t(*args, torch.zeros((n, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="lanes run past"):
        dd.decode_lanes_t(*args[:5], 1, lanes.starts,
                          torch.zeros((n, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="cols_run"):
        dd.decode_lanes_t(*args, torch.zeros((n, 4), dtype=torch.uint8),
                          cols_run=5)


# ---------------------------------------------------------------------------
# Pipeline level: bytes against qvz_tpu's decoders.


def _assert_decodes(comp, jax_device=True):
    host = host_decode.decode(comp)
    st = {}
    got = port.decode(comp, device="cpu", stats=st)
    assert np.array_equal(got, host)
    if jax_device:
        assert np.array_equal(got, host_decode.decode(comp, device=True))
    return st


CONFIGS = [
    dict(ratio=0.5, n_clusters=1, shards=4),
    dict(ratio=0.2, n_clusters=1, shards=3),
    dict(ratio=0.8, n_clusters=1, shards=6),
    dict(ratio=0.5, n_clusters=3, shards=4),
    dict(ratio=0.9, n_clusters=2, shards=5),
]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=[f"r{c['ratio']}_c{c['n_clusters']}_"
                              f"s{c['shards']}" for c in CONFIGS])
def test_decode_byte_equal(cfg):
    """The configs of qvz_tpu's device-decode tests, at a smaller size."""
    comp = _encode(_data(800, 8, seed=11), prime=False, **cfg)
    st = _assert_decodes(comp)
    assert st["lanes"] == cfg["shards"] and st["fallback_lanes"] == 0
    assert set(st["phase_seconds"]) == {
        "parse", "draws", "h2d", "warmup", "prologue", "decoder", "d2h",
        "redecode"}


def test_decode_lanes_that_rescale():
    """The container of test_torch_encode's rescale input, whose lanes
    qvz_tpu's device decoder flags and decodes again on the host: the
    port decodes every lane (fallback_lanes 0), byte-equal to the host
    decoder."""
    from test_torch_encode import RESCALE_KW, rescale_input

    comp = _encode(rescale_input(), **RESCALE_KW)
    st = _assert_decodes(comp, jax_device=False)
    assert st["lanes"] == len(_tables(comp)[0].shards) - 1 > 1000
    assert st["fallback_lanes"] == 0
    lanes = port.prepare_lanes(comp, "cpu")
    assert cd.risk_tables(lanes.dplan_t, max(lanes.lane_counts))["models"]


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_decode_primed(small_warmup, n_clusters):
    comp = _encode(_data(1600, 6, seed=2 + n_clusters), shards=4,
                   prime=True, n_clusters=n_clusters)
    assert container_v2.parse(comp, blocks_len=None).priming
    st = _assert_decodes(comp, jax_device=False)
    assert st["lanes"] == 4


def _synth(n, cols, seed, kind):
    """The pathological shapes of qvz_tpu's device-decode tests."""
    rng = np.random.default_rng(seed)
    if kind == "constant":
        q = np.full((n, cols), 38, dtype=np.uint8)
        q[n // 3] = 2
    elif kind == "bimodal":
        lo = rng.integers(0, 6, size=(n, cols))
        hi = rng.integers(60, 72, size=(n, cols))
        q = np.where(rng.random((n, 1)) < 0.5, lo, hi).astype(np.uint8)
    elif kind == "saturated":
        q = np.clip(rng.integers(66, 80, size=(n, cols)), 0,
                    71).astype(np.uint8)
    else:
        q = rng.integers(0, 72, size=(n, cols)).astype(np.uint8)
    return q


@pytest.mark.parametrize("kind,cfg", [
    ("constant", dict(shards=3, n_clusters=1)),
    ("bimodal", dict(shards=4, n_clusters=2)),
    ("saturated", dict(shards=3, n_clusters=1, ratio=0.9)),
    ("uniform", dict(shards=4, n_clusters=3, ratio=0.3)),
])
def test_decode_pathological_shapes(kind, cfg):
    comp = _encode(_synth(900, 8, 47, kind), prime=False, **cfg)
    _assert_decodes(comp, jax_device=False)


def test_decode_single_column_and_ragged():
    _assert_decodes(_encode(_data(901, 1, seed=9), shards=3, prime=False),
                    jax_device=False)
    _assert_decodes(_encode(_data(1001, 6, seed=5), shards=5, prime=False),
                    jax_device=False)


def _rebuild(comp, mutate):
    head, _ = _tables(comp)
    pays = [bytes(comp[s.payload_off:s.payload_off + s.payload_len])
            for s in head.shards]
    return container_v2.build(
        bytes(head.blocks), head.cluster_count, head.columns, head.lines,
        [s.lines for s in head.shards],
        [bytes(s.well_state) for s in head.shards], mutate(pays),
        order=head.order, priming=head.priming)


def test_truncated_payload_raises():
    """A payload cut to a quarter, with a consistent checksum: the lane is
    flagged (overrun) and the host decode of it raises."""
    comp = _rebuild(_encode(_data(900, 8, seed=37), shards=3,
                            prime=False),
                    lambda p: p[:-1] + [p[-1][: len(p[-1]) // 4]])
    with pytest.raises(ValueError):
        host_decode.decode(comp)
    lanes = port.prepare_lanes(comp, "cpu")
    _, flags, final = _port_lanes(lanes, 8)
    assert flags.tolist() == [False, False, True]
    assert final[2, 4] & dd.FLAG_OVERRUN
    with pytest.raises(ValueError):
        port.decode(comp, device="cpu")


def test_corrupt_warmup_raises_not_hangs(small_warmup):
    comp = bytearray(_encode(_data(1600, 6, seed=41), shards=4, prime=True))
    head, _ = _tables(bytes(comp))
    assert head.priming
    comp[head.shards[0].payload_off] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        port.decode(bytes(comp), device="cpu")


def test_corrupt_lane_checksum_raises():
    comp = bytearray(_encode(_data(600, 5, seed=42), shards=3,
                             prime=False))
    head, _ = _tables(bytes(comp))
    comp[head.shards[2].payload_off] ^= 0x01
    with pytest.raises(ValueError, match="shard 2 payload checksum"):
        port.decode(bytes(comp), device="cpu")


def test_containers_without_lanes_go_to_the_host():
    """v1, single-shard QVZ2 and row-major QVZ2 have no lanes."""
    data = _data(700, 6, seed=17)
    v1 = _encode(data, shards=1)
    assert not container_v2.is_v2(v1)
    assert np.array_equal(port.decode(v1, device="cpu"),
                          host_decode.decode(v1))

    col = _encode(data, shards=3, prime=False)
    head, tables = _tables(col)

    def row_major(_):
        offs = np.concatenate([[0], np.cumsum([s.lines
                                               for s in head.shards])])
        return [rt.encode_fused(tables, data[offs[i]:offs[i + 1]], None,
                                np.frombuffer(s.well_state, "<u4"))[0]
                for i, s in enumerate(head.shards)]

    row = container_v2.build(
        bytes(head.blocks), head.cluster_count, head.columns, head.lines,
        [s.lines for s in head.shards],
        [bytes(s.well_state) for s in head.shards], row_major(None),
        order=container_v2.ORDER_LINE)
    st = {}
    got = port.decode(row, device="cpu", stats=st)
    assert st == {}
    assert np.array_equal(got, host_decode.decode(row))
    assert np.array_equal(got, port.decode(col, device="cpu"))


def test_port_encode_round_trip(small_warmup):
    """Containers from the port's own encode decode to its -u
    reconstruction."""
    data = _data(1300, 8, seed=21)
    for kw in (dict(shards=8, prime=True), dict(shards=8, n_clusters=3,
                                                prime=False)):
        out = port_encode.encode(data, DIST, well_state=WellState.debug(),
                                 device="cpu", **kw)
        got = port.decode(out.compressed, device="cpu")
        assert np.array_equal(got[:, :8], out.reconstructed + 33)
        assert np.array_equal(got, host_decode.decode(out.compressed))


def test_decode_files(tmp_path):
    """decode_file_to_file writes through a memory map; an empty file
    raises as in qvz_tpu."""
    comp = _encode(_data(500, 5, seed=23), shards=3, prime=False)
    src, dst = tmp_path / "c.q", tmp_path / "o"
    src.write_bytes(comp)
    assert port.decode_file_to_file(str(src), str(dst), device="cpu") == 500
    assert dst.read_bytes() == host_decode.decode(comp).tobytes()
    (tmp_path / "e.q").write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        port.decode_file_to_file(str(tmp_path / "e.q"), str(dst),
                                 device="cpu")


def test_decode_plan_model_records():
    """K5's per-column model records: each model's column-local index
    points at its slot base, cardinality and initial total."""
    comp = _encode(_data(600, 5, seed=43), shards=3, n_clusters=3,
                   prime=False)
    _, tables = _tables(comp)
    plan = cd.LanePlan(tables, None)
    dplan = dd.DecodePlan(plan, tables)
    for c, ms in enumerate(plan.col_models):
        rec = dplan.mtab[dplan.col_model_off[c] + dplan.mloc[ms]]
        assert np.array_equal(rec[:, 0], plan.slot_base[ms])
        assert np.array_equal(rec[:, 1] >> 20, plan.cards[ms])
        assert np.array_equal(rec[:, 1] & 0xFFFFF, plan.totals[ms])
    assert dplan.col_model_off[-1] == len(dplan.mtab) == len(plan.cards) - 1


@pytest.mark.parametrize("S,models,lmax,lpw,want", [
    (1004, 140, 240, 8, (8, 32, 240)),       # -c 1 at 1M x 100
    (2361, 432, 260, 32, (32, 32, 264)),     # -c 3, every model of a column
    (2361, 432, 150_000, 8, (8, 32, 256)),   # lanes of 150,000 lines
    (20_000, 400, 260, 8, (2, 2, 256)),      # two lanes a block
])
def test_launch_shape_fits(S, models, lmax, lpw, want):
    limit = 232_448 - 1024
    shape = dd.launch_shape(S, models, lmax, 216, lpw, limit)
    assert (shape["lpw"], shape["lpb"], shape["lt"]) == want
    assert shape["layout"] == 0
    assert shape["smem"] <= limit
    assert shape["s_pad"] % 8 == 0 and shape["m_pad"] % 8 == 0


def test_launch_shape_refuses():
    """A forced layout that cannot hold one lane, a lanes-a-warp that is
    not a power of two and more models a column than a u16 tile entry
    indexes raise; nothing else does."""
    with pytest.raises(ValueError, match="layout 0 .* shared memory"):
        dd.launch_shape(200_000, 400, 260, 216, 8, 231_424, layout=0)
    with pytest.raises(ValueError, match="layout 1 .* shared memory"):
        dd.launch_shape(200_000, 400, 260, 216, 8, 231_424, layout=1)
    with pytest.raises(ValueError, match="power of two"):
        dd.launch_shape(1004, 140, 240, 216, 12, 231_424)
    with pytest.raises(ValueError, match="models in a column"):
        dd.launch_shape(1004, (1 << 16) + 1, 240, 216, 8, 231_424)
    assert dd.launch_shape(1004, 1 << 15, 240, 216, 8, 231_424)["lpb"] == 2


@pytest.mark.parametrize("S,models,lmax,ptab_w,want", [
    (17_100, 7_174, 260, 150 * 72, (4, 4, 256, 1)),   # -c 150, 200k x 20
    (200_000, 400, 260, 216, (8, 32, 264, 2)),        # one lane's uses
    (10**6, 36_720, 150_000, 255 * 72, (8, 32, 2048, 2)),  # -c 255
])
def test_launch_shape_layouts(S, models, lmax, ptab_w, want):
    """Where the column's tables and one lane's uses do not fit a block
    together, K5 reads the tables from device memory (layout 1); where
    one lane's uses alone do not fit, it keeps them there too (layout 2).
    Every plan has a layout, so K5 takes every plan."""
    limit = 232_448 - 1024
    shape = dd.launch_shape(S, models, lmax, ptab_w, 8, limit)
    assert (shape["lpw"], shape["lpb"], shape["lt"],
            shape["layout"]) == want
    assert shape["smem"] <= limit
    assert dd.launch_shape(S, models, lmax, ptab_w, 8, limit,
                           layout=shape["layout"]) == shape


def test_payloads_are_padded_for_wide_loads():
    pays = [b"\x01\x02\x03", b"", b"\xff" * 9]
    packed = dd.pack_payloads(pays, "cpu")
    assert packed.flat.numel() == 24 and packed.flat.numel() % 8 == 0
    assert packed.flat[:12].tolist() == [1, 2, 3] + [255] * 9
    assert not packed.flat[12:].any()
    assert packed.off.tolist() == [0, 3, 3]
    assert packed.lens.tolist() == [3, 0, 9]


@pytest.mark.cuda
def test_cuda_lanes_per_warp_agree():
    """K5 on the card gives the plain version's rows and states at every
    lanes-a-warp setting (chip_smoke.py runs this at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    comp = _encode(_data(2000, 6, seed=44), shards=8, n_clusters=3,
                   prime=False)
    lanes = port.prepare_lanes(comp, "cuda")
    n = lanes.draws_t.shape[1]
    want = torch.zeros((n, 7), dtype=torch.uint8, device="cuda")
    fin = dd.decode_lanes_reference(lanes.dplan_t, lanes.pays, lanes.draws_t,
                                    lanes.cl, lanes.lane_counts, 0,
                                    lanes.starts, want, 33)
    for lpw in (32, 16, 8, 4, 2, 1):
        got = torch.zeros_like(want)
        f = dd.decode_lanes_t(lanes.dplan_t, lanes.pays, lanes.draws_t,
                              lanes.cl, lanes.lane_counts, 0, lanes.starts,
                              got, 33, lanes_per_warp=lpw)
        assert torch.equal(f, fin) and torch.equal(got, want), lpw


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [0, 1, 2])
def test_cuda_layouts_agree(layout):
    """K5 on the card gives the plain version's rows and states in each of
    its layouts."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    comp = _encode(_data(2000, 6, seed=45), shards=8, n_clusters=3,
                   prime=False)
    lanes = port.prepare_lanes(comp, "cuda")
    n = lanes.draws_t.shape[1]
    want = torch.zeros((n, 7), dtype=torch.uint8, device="cuda")
    fin = dd.decode_lanes_reference(lanes.dplan_t, lanes.pays, lanes.draws_t,
                                    lanes.cl, lanes.lane_counts, 0,
                                    lanes.starts, want, 33)
    got = torch.zeros_like(want)
    f = dd.decode_lanes_t(lanes.dplan_t, lanes.pays, lanes.draws_t, lanes.cl,
                          lanes.lane_counts, 0, lanes.starts, got, 33,
                          layout=layout)
    assert torch.equal(f, fin) and torch.equal(got, want)


@pytest.mark.parametrize("prime", [False, True], ids=["noprime", "prime"])
def test_decode_in_waves(small_warmup, monkeypatch, prime):
    """A tiny wave budget decodes the lanes in several K5 calls, byte-equal
    to one wave and to the host decoder."""
    comp = _encode(_data(1600, 6, seed=46), shards=6, n_clusters=2,
                   prime=prime)
    one = {}
    want = port.decode(comp, device="cpu", stats=one)
    assert one["waves"] == 1
    monkeypatch.setattr(port, "WAVE_BYTES", 2 * 13 * 250)
    plans = []
    to_torch = dd.decode_plan_to_torch
    monkeypatch.setattr(dd, "decode_plan_to_torch",
                        lambda *a: plans.append(a) or to_torch(*a))
    st = {}
    got = port.decode(comp, device="cpu", stats=st)
    assert st["waves"] >= 3 and st["lanes"] == one["lanes"]
    assert len(plans) == 1          # one decode plan serves every wave
    assert st["fallback_lanes"] == 0
    assert np.array_equal(got, want)
    assert np.array_equal(got, host_decode.decode(comp))


# ---------------------------------------------------------------------------
# K5p: every lane's start, and its cluster-id prologue, on the device.


def _host_prologues(comp, lanes):
    """qvz_tpu's rt.decode_cluster_prologue of each lane of a container:
    (ids, l, u, t, consumed bits), or the status it raises with."""
    head, tables = _tables(comp)
    out = []
    for i in range(lanes.first, len(head.shards)):
        s = head.shards[i]
        pay = bytes(comp[s.payload_off:s.payload_off + s.payload_len])
        try:
            out.append(rt.decode_cluster_prologue(tables, pay, s.lines,
                                                  init_bank=lanes.bank))
        except ValueError as e:
            out.append(int(str(e).split()[-1]))
    return out


def _assert_prologues(lanes, got, host):
    """K5p's (cl, states, flags) equal the host's prologue lane by lane:
    the ids and (l, u, t, consumed bits) where it passes, FLAG_BAD where
    it fails with -3 and FLAG_CLUSTER with -1."""
    cl, states, flags = got
    offs = np.concatenate([[0], np.cumsum(lanes.lane_counts)])
    for w, h in enumerate(host):
        if isinstance(h, int):
            assert int(flags[w]) == {-3: dd.FLAG_BAD,
                                     -1: dd.FLAG_CLUSTER}[h], f"lane {w}"
            continue
        assert int(flags[w]) == 0, f"lane {w}"
        assert np.array_equal(cl[offs[w]:offs[w + 1]].numpy(), h[0]), w
        assert states[w].tolist() == list(h[1:]), f"lane {w}"


@pytest.mark.parametrize("n_clusters", [2, 3])
@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
def test_cluster_prologue_reference_matches_host(small_warmup, n_clusters,
                                                 prime):
    """K5p's plain version equals qvz_tpu's host prologue on every lane,
    ragged lanes and a primed bank included; some lanes start K5
    mid-byte."""
    comp = _encode(_data(1043, 6, seed=60 + n_clusters), shards=5,
                   prime=prime, n_clusters=n_clusters)
    lanes = port.prepare_lanes(comp, "cpu")
    assert len(set(lanes.lane_counts)) == 2
    assert (lanes.bank is not None) == prime
    got = dd.cluster_prologue_reference(lanes.dplan_t, lanes.pays,
                                        lanes.lane_counts)
    _assert_prologues(lanes, got, _host_prologues(comp, lanes))
    assert not got[2].any() and (got[1][:, 3] % 8 != 0).any()
    assert torch.equal(got[0], lanes.cl)
    assert torch.equal(got[1], lanes.starts)


def test_cluster_prologue_one_cluster_starts():
    """With one cluster no id is decoded: each lane starts at the full
    interval and its payload's first 22 bits (start_state)."""
    comp = _encode(_data(600, 5, seed=62), shards=4, prime=False)
    lanes = port.prepare_lanes(comp, "cpu")
    cl, states, flags = dd.cluster_prologue_reference(
        lanes.dplan_t, lanes.pays, lanes.lane_counts)
    assert cl is None and lanes.cl is None and not flags.any()
    assert states.tolist() == [list(dd.start_state(p))
                               for p in _payloads(lanes)]


def _model0_bank(tables, counts, total):
    """A bank of counts ones and totals the cardinalities, but model 0's
    counts and total as given (a total that is not their sum makes the
    host's prologue fail)."""
    cards = np.asarray(tables.model_card, dtype=np.int64)
    moff = np.asarray(tables.model_off, dtype=np.int64)
    bank = np.concatenate([np.ones(int(moff[-1]), dtype=np.uint32),
                           cards.astype(np.uint32)])
    bank[:len(counts)] = counts
    bank[int(moff[-1])] = total
    return bank


def _bank_lanes(comp, bank):
    """prepare_lanes of `comp` with its plan built from `bank`."""
    lanes = port.prepare_lanes(comp, "cpu")
    _, tables = _tables(comp)
    return lanes._replace(bank=bank, dplan_t=dd.decode_plan_to_torch(
        dd.DecodePlan(cd.LanePlan(tables, bank), tables), "cpu"))


# model 0's (counts, total): the sum (the host passes), a total below it
# (the tag leaves [l, u]: -3) and above it (the search passes the last
# count: -1)
BANKS = [([40, 40, 40], 120), ([40, 40, 40], 50), ([1, 200, 1], 8),
         ([1, 1, 1], 1000), ([5, 1, 1], 1000)]


def test_cluster_prologue_flags_like_the_host():
    """Where the host's prologue fails (a bank whose model 0 total is not
    its counts' sum), K5p's plain version flags the lane with the host's
    reason, and decodes every other lane as the host does."""
    comp = _encode(_data(600, 4, seed=4), shards=4, prime=False,
                   n_clusters=3)
    _, tables = _tables(comp)
    seen = set()
    for counts, total in BANKS:
        lanes = _bank_lanes(comp, _model0_bank(tables, counts, total))
        host = _host_prologues(comp, lanes)
        _assert_prologues(lanes, dd.cluster_prologue_reference(
            lanes.dplan_t, lanes.pays, lanes.lane_counts), host)
        seen.update(h if isinstance(h, int) else 0 for h in host)
    assert seen == {0, -1, -3}


def test_cluster_prologue_rescales_twice():
    """Model 0 started 24 short of 2^19 in lanes of 33,000 reads: it
    rescales at a lane's fourth id and again about 32,768 ids later; K5p's
    plain version equals the host's prologue through both."""
    n, W = 66_000, 2
    rng = np.random.default_rng(63)
    data = _data(n, 1, seed=63)
    clusters = rng.integers(0, 3, size=n).astype(np.uint8)
    c0, cond = rt.stats_host(data, clusters, 3)
    from qvz_tpu.constants import MODE_RATIO
    tables = rt.Design(c0, cond, MODE_RATIO, 0.5, DIST).tables()
    bank = _model0_bank(tables, [ARITH_R - 26, 1, 1], ARITH_R - 24)
    lane_counts = [n // W] * W
    states = np.stack([WellState.debug().state] * W).astype(np.uint32)
    pays = []
    for w in range(W):
        ids = clusters[w * (n // W):(w + 1) * (n // W)]
        md, qs, _, _ = rt.quantize_colmajor(
            tables, np.ascontiguousarray(data[w * (n // W):(w + 1) * (n // W)]
                                         .T), ids, states[w])
        pays.append(rt.encode_precomputed_colmajor(tables, md, qs, ids,
                                                   n // W, init_bank=bank))
        tri = rt.replay_model(bank[:3], ARITH_R - 24, ids)
        assert (tri[1:, 2] != tri[:-1, 2] + 8).sum() >= 2
    dplan_t = dd.decode_plan_to_torch(
        dd.DecodePlan(cd.LanePlan(tables, bank), tables), "cpu")
    cl, st, flags = dd.cluster_prologue_reference(
        dplan_t, dd.pack_payloads(pays, "cpu"), lane_counts)
    assert not flags.any()
    assert np.array_equal(cl.numpy(), clusters)
    for w in range(W):
        h = rt.decode_cluster_prologue(tables, pays[w], n // W,
                                       init_bank=bank)
        assert st[w].tolist() == list(h[1:]), f"lane {w}"


@pytest.mark.cuda
def test_cuda_cluster_prologue_matches_plain():
    """K5p equals its plain version on the card: -c 3 primed and
    unprimed, one cluster, and the banks that make lanes fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K5p has no CPU mode)")
    comps = [_encode(_data(1043, 6, seed=61), shards=5, prime=p,
                     n_clusters=k) for p, k in ((True, 3), (False, 3),
                                                (False, 1))]
    cases = [port.prepare_lanes(c, "cpu") for c in comps]
    _, tables = _tables(comps[1])
    cases += [_bank_lanes(comps[1], _model0_bank(tables, c, t))
              for c, t in BANKS]
    for lanes in cases:
        want = dd.cluster_prologue_reference(lanes.dplan_t, lanes.pays,
                                             lanes.lane_counts)
        dplan = {k: v.cuda() if torch.is_tensor(v) else v
                 for k, v in lanes.dplan_t.items()}
        got = dd.cluster_prologue(dplan, dd.pack_payloads(
            _payloads(lanes), "cuda"), lanes.lane_counts)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a.cpu(), b)
