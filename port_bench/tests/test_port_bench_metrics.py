"""The arithmetic of the metrics: phase means, the union of the card's
intervals, idle gaps, kernel sums by layer, the rooflines' least work,
and the window's rate."""

import pytest

from port_bench import run, trace, work


def _window(op="encode", events=None, lo=0.0, hi=100.0, files=None):
    files = files or [
        dict(phases={"design": 0.25, "draws": 0.5}, work=dict(
            lines=10, columns=4, payload_bytes=100, text_bytes=50)),
        dict(phases={"design": 0.75, "draws": 0.5}, work=dict(
            lines=10, columns=4, payload_bytes=100, text_bytes=50))]
    return run.Window(op, files, events, lo, hi)


def test_phase_mean_ms():
    w = _window()
    assert w.phase_ms("encode", "design") == pytest.approx(500.0)
    assert w.phase_ms("decode", "design") is None
    assert w.phase_ms("encode", "parse") is None


def test_busy_is_the_union():
    ev = [(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (22, 25, "d")]
    assert trace.busy_us(ev) == 25
    gaps = sorted(trace.gaps(ev, 0, 40), reverse=True)
    assert [g for g, _ in gaps] == [10, 5]


def test_idle_share_reader():
    ev = [(0, 10, "void chain_kernel<1>"), (20, 30, "Memcpy HtoD")]
    w = _window(events=ev, lo=0, hi=100)
    assert run.reader("dev.idle_pct.enc").read(w) == pytest.approx(80.0)


def test_roofline_reader_sums_the_layer():
    ev = [(0, 100, "void (anonymous namespace)::triples_kernel<0>()"),
          (100, 300, "void (anonymous namespace)::chain_kernel()"),
          (300, 400, "hist_kernel")]
    w = _window(events=ev)
    assert w.kernel_s(work.CODER_KERNELS) == pytest.approx(300e-6)
    least = 2 * work.coder_least_s(10, 4, 100)
    got = run.reader("kern.coder_roofline").read(w)
    assert got == pytest.approx(100 * least / 300e-6)


def test_least_work_counts():
    # 40 symbols: 3 bytes each, a cluster id a read, the payload
    assert work.coder_least_s(10, 4, 100) == pytest.approx(
        max(230 / work.HBM_BYTES_PER_S, 50 * 17 / work.INT_OPS_PER_S))


def test_rate_over_the_window(monkeypatch):
    """encode_MBps is the text of every completed file over the time
    from the window's start to the end of the last file."""
    from port_bench.ops import encode
    clock = iter(float(t) for t in range(1000))
    monkeypatch.setattr(run.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(encode, "run", lambda item, cfg, seed, dev: (
        b"x", {}, dict(lines=1, columns=1, payload_bytes=1,
                       text_bytes=2_000_000)))
    monkeypatch.setattr(encode, "expected", lambda *a, **k: None)
    monkeypatch.setattr(encode, "compare", lambda outs, want: {
        "checked_bytes_off": (0, 0)})
    r = run.run_cell("c3-encode-10m", 5, 3.0, False, device="cpu",
                     traffic_over={"reads": 8, "pool": 1,
                                   "warmup_calls": 0},
                     cfg_over={"columns": 4, "clusters": 1}, t_start=0.0,
                     log=lambda *a: None)
    # the clock ticks once a call: files end at window + 2, + 4, ...
    files = r["attempted"]
    window = 2 * files + 1
    assert r["metrics"]["encode_MBps"]["value"] == pytest.approx(
        files * 2.0 / window)
    assert r["correct"]
