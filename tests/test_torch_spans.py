"""The port's phase spans (utils/spans.py) and what the device encode
records with them: the phases inside draws, design, device_code and code,
the counters, the design's native statistics, and the profiler's
qvz.<phase> ranges. None of it changes a byte of the container."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.native import runtime as jx_rt
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState as JWell
from qvz_tpu.pipeline import encode as host_encode
from qvz_tpu_torch import api
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host as port_host
from qvz_tpu_torch.utils import spans
from qvz_tpu_torch.utils.spans import span

DIST = make_matrix(DISTORTION_MSE)
# each new phase and the phase it lies in
INSIDE = {"jump": "draws", "fill": "draws", "design_serial": "design",
          "warmup_prep": "device_code", "warmup_wait": "device_code",
          "coder_plan": "device_code", "lanes": "device_code",
          "payload_finish": "device_code", "device_code": "code",
          "container": "code"}
# the phases that divide device_code among them
IN_DEVICE_CODE = ("warmup_prep", "coder_plan", "lanes", "payload_finish",
                  "warmup_wait")


def _data(n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.fixture
def small_warmup(monkeypatch):
    """Prime with a 512-line warmup shard in both packages."""
    monkeypatch.setattr(host_encode, "PRIME_WARMUP_LINES", 512)
    monkeypatch.setattr(port_host, "PRIME_WARMUP_LINES", 512)


def _qvz_ranges(prof) -> list:
    return sorted((e.time_range.start, e.time_range.end, e.name,
                   e.is_user_annotation) for e in prof.events()
                  if e.name.startswith(spans.PREFIX))


def test_span_adds_its_seconds_and_nests():
    ph: dict = {}
    with span(ph, "outer"):
        with span(ph, "inner"):
            pass
        with span(ph, "inner"):
            pass
    with span(ph, "outer"):
        pass
    assert set(ph) == {"outer", "inner"}
    assert 0.0 <= ph["inner"] <= ph["outer"]
    with pytest.raises(KeyError):
        with span(ph, "failed"):
            raise KeyError("x")
    assert "failed" not in ph


def test_span_opens_a_range_only_under_a_profiler(monkeypatch):
    opened: list = []
    real = torch._C._profiler._RecordFunctionFast

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        recording)
    ph: dict = {}
    with span(ph, "idle"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span(ph, "traced"):
            with span(ph, "inner"):
                torch.ones(4).sum()
    assert opened == ["qvz.traced", "qvz.inner"]
    got = _qvz_ranges(prof)
    assert [(name, user) for _, _, name, user in got] == [
        ("qvz.traced", False), ("qvz.inner", False)]
    (a, b, _, _), (c, d, _, _) = got
    assert a <= c <= d <= b
    assert set(ph) == {"idle", "traced", "inner"}


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_device_encode_phases_and_counters(small_warmup, n_clusters):
    """The new phases lie inside the ones that held them, the counters
    count, the profiler sees one operator range a phase (no user range,
    which it would also draw on the card's timeline), and the container
    is qvz_tpu's."""
    n, cols, shards = 1100, 4, 64
    data = _data(n, cols, seed=n_clusters)
    kw = dict(n_clusters=n_clusters, ratio=0.5, shards=shards,
              want_recon=False)
    want = host_encode.encode(data, DIST, well_state=JWell.debug(),
                              use_jax=False, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = port.encode(data, DIST, well_state=WellState.debug(),
                          device="cpu", **kw)
    assert got.compressed == want.compressed
    ph, dv, ct = (got.stats.phase_seconds, got.stats.device_seconds,
                  got.stats.counters)
    assert set(ph) == {"h2d", "cluster", "stats", "design", "draws",
                       "quantize", "device_code", "d2h", "code"} | set(INSIDE)
    for phase, outer in INSIDE.items():
        assert 0.0 <= ph[phase] <= ph[outer], phase
    assert ph["jump"] + ph["fill"] <= ph["draws"]
    assert sum(ph[p] for p in IN_DEVICE_CODE) <= ph["device_code"]
    # the lanes' copy to the host (no recon is asked for)
    assert ph["d2h"] <= ph["lanes"]
    assert set(dv) == {"h2d", "stats", "quantize", "device_code", "d2h"} \
        | ({"cluster"} if n_clusters > 1 else set())
    assert set(ct) == {"h2d_bytes", "device_draws", "device_jumps",
                       "lloyd_iters", "lloyd_discarded_iters",
                       "coder_models", "coder_models_at_risk"}
    # the reads and the host's draws (on the CPU), then the lane plan
    assert ct["h2d_bytes"] > 2 * n * cols
    assert ct["device_draws"] == 0
    assert ct["device_jumps"] == 0
    assert 0 <= ct["lloyd_discarded_iters"] <= ct["lloyd_iters"]
    assert ct["lloyd_iters"] > 0

    ranges = _qvz_ranges(prof)
    # the native design_serial, and d2h, a sum of copies inside
    # device_code (a span only for the recon), have no range here
    timed = set(ph) - {"design_serial", "d2h"}
    # h2d twice: the reads, then the draws
    assert sorted(name for _, _, name, _ in ranges) == sorted(
        [spans.PREFIX + p for p in timed] + ["qvz.h2d"])
    assert not any(user for *_, user in ranges)
    where = {name: (a, b) for a, b, name, _ in ranges}
    for phase, outer in INSIDE.items():
        if phase in timed:
            (a, b), (c, d) = where["qvz." + phase], where["qvz." + outer]
            assert c <= a <= b <= d, phase
    # device_code's phases follow one another, none inside another
    inner = sorted(where["qvz." + p] for p in IN_DEVICE_CODE)
    assert all(b <= c for (_, b), (c, _) in zip(inner, inner[1:]))


def _rescale_input():
    """test_torch_encode's input whose primed warmup shard leaves a model
    within a lane's updates of 2^19: 12 x 65,520 reads of 30 or 31."""
    rng = np.random.default_rng(7)
    return (30 + rng.integers(0, 2, (12 * 65_520, 1))).astype(np.uint8)


@pytest.mark.parametrize("case", ["small", "rescale"])
def test_coder_counters_are_risk_tables_counts(small_warmup, monkeypatch,
                                               case):
    """coder_models counts the lane plan's models (every model but the
    cluster-id model) and coder_models_at_risk ``risk_tables``' models at
    the file's longest lane, for a plan rebuilt here from the container:
    its codebooks and the bank of its warmup shard."""
    from qvz_tpu_torch.format import container_v2 as cv
    from qvz_tpu_torch.ops import coder_device as cd
    if case == "small":
        data, kw = _data(1100, 4, seed=7), dict(shards=64, ratio=0.5)
    else:
        monkeypatch.setattr(port_host, "PRIME_WARMUP_LINES", 65536)
        data, kw = _rescale_input(), dict(shards=1801, ratio=1.0)
    got = port.encode(data, DIST, well_state=WellState.debug(),
                      device="cpu", want_recon=False, **kw)
    blob = got.compressed
    tables = rt.tables_from_blocks(blob[cv.header_size():], 1,
                                   data.shape[1])
    head = cv.parse(blob, tables.consumed)
    assert head.priming == 1
    w_n = head.shards[0].lines
    md0, qs0, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data[:w_n].T), None,
        np.frombuffer(head.shards[0].well_state, dtype="<u4"))
    bank = rt.bank_from_stream(tables, md0, qs0, None, w_n)
    plan_t = cd.plan_to_torch(cd.LanePlan(tables, bank), "cpu")
    lmax = max(s.lines for s in head.shards[1:])
    at_risk = cd.risk_tables(plan_t, lmax)["models"]
    ct = got.stats.counters
    assert ct["coder_models"] == len(plan_t["mtab_h"]) \
        == int(tables.n_models) - 1
    assert ct["coder_models_at_risk"] == at_risk
    assert (at_risk > 0) == (case == "rescale")


def test_compress_bytes_times_the_parse(small_warmup):
    data = _data(1601, 6, seed=5)
    text = (np.concatenate([data + 33, np.full((len(data), 1), 10,
                                               np.uint8)], 1)).tobytes()
    blob, st = api.compress_bytes(text, shards=8, debug_seed=True,
                                  device="cpu")
    want = host_encode.encode(data, DIST, well_state=JWell.debug(),
                              use_jax=False, shards=8, want_recon=False)
    assert blob == want.compressed
    assert st.phase_seconds["parse"] >= 0.0


def test_design_stats_repeat_and_leave_the_books_alone():
    """Two designs of one input count the same, discarded iterations
    among all of them, and serialize qvz_tpu's codebooks."""
    data = _data(3000, 10, seed=9)
    clusters = (np.arange(len(data)) % 3).astype(np.uint8)
    counts0, cond = rt.stats_host(data, clusters, 3)
    one = rt.Design(counts0, cond, 0, 0.5, DIST)
    two = rt.Design(counts0, cond, 0, 0.5, DIST)
    s1, s2 = one.stats(), two.stats()
    assert s1.pop("serial_s") >= 0.0 and s2.pop("serial_s") >= 0.0
    assert s1 == s2
    assert 0 <= s1["lloyd_discarded_iters"] <= s1["lloyd_iters"]
    jx = jx_rt.Design(counts0, cond, 0, 0.5, DIST)
    assert one.serialized() == two.serialized() == jx.serialized()


def test_host_engine_keeps_its_phases(small_warmup):
    """The host engine (qvz_tpu's host encode's counterpart) times its
    four phases and no other, and counts nothing."""
    st = port_host.encode(_data(1601, 6, seed=3), DIST, shards=8,
                          n_clusters=2).stats
    assert set(st.phase_seconds) == {"cluster", "stats", "design", "code"}
    assert st.counters == {}
