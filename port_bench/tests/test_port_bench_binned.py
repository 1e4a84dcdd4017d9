"""The NovaSeq cell (`nova-encode-7m`): its configuration and traffic
load with every key acted on, the binned encode's rule for a bin, the
readers of the device coder's spans and roofline for both encode
operations, and a small run on the CPU (the kernels' plain versions)
that comes out correct, 0 bytes off the plain reference."""

import numpy as np
import pytest

from port_bench import run
from port_bench.ops import encode_binned

CELL = "nova-encode-7m"
READERS = {"enc.coder_plan_ms": "coder_plan", "enc.lanes_ms": "lanes",
           "enc.payload_finish_ms": "payload_finish"}


def test_the_cell_loads_every_key():
    spec = run.load_cell(CELL)
    assert spec["traffic"]["op"] == "encode_binned"
    assert set(spec["cfg"]) - run.TEXT_KEYS \
        == run.CONFIG_KEYS | encode_binned.CONFIG_KEYS
    assert spec["cfg"]["bins"] == [2, 12, 23, 37]
    assert spec["cfg"]["columns"] == 151 and spec["cfg"]["clusters"] == 1
    assert {m["name"] for m in spec["end_to_end"]} == {"encode_MBps",
                                                       "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} \
        == set(READERS) | {"kern.coder_roofline_any"}


def test_the_bin_of_a_quality():
    table = encode_binned.bin_table([37, 2, 23, 12])
    got = {q: int(table[q + 33]) - 33 for q in (6, 7, 17, 18, 30, 31)}
    assert got == {6: 2, 7: 2, 17: 12, 18: 23, 30: 23, 31: 37}
    assert table[10] == 10
    text = bytes([33 + 0, 33 + 41, 33 + 24, 10])
    assert encode_binned.bin_text(text, [2, 12, 23, 37]) \
        == bytes([33 + 2, 33 + 37, 33 + 23, 10])


def _window(op, phases, work=None):
    work = work or dict(lines=10, columns=4, payload_bytes=100,
                        text_bytes=50)
    return run.Window(op, [dict(phases=p, work=work) for p in phases])


@pytest.mark.parametrize("op", ["encode", "encode_binned"])
@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_reads_both_encodes(name, op):
    phase = READERS[name]
    read = run.reader(name).read
    assert read(_window(op, [{phase: 0.25}, {phase: 0.75}])) \
        == pytest.approx(500.0)
    # a program without the phase (the parent) gives no reading
    assert read(_window(op, [{"draws": 1.0}, {"draws": 1.0}])) is None
    assert read(_window("decode", [{phase: 0.25}])) is None


@pytest.mark.parametrize("op", ["encode", "encode_binned"])
def test_roofline_reader_reads_both_encodes(op):
    from port_bench import work
    ev = [(0, 100, "void (anonymous namespace)::triples_kernel<0>()"),
          (100, 300, "void (anonymous namespace)::chain_kernel()")]
    files = [dict(phases={}, work=dict(lines=10, columns=4,
                                       payload_bytes=100, text_bytes=50))]
    win = run.Window(op, files * 2, ev, 0, 400)
    want = 100 * 2 * work.coder_least_s(10, 4, 100) / 300e-6
    assert run.reader("kern.coder_roofline_any").read(win) \
        == pytest.approx(want)
    if op == "encode":
        assert run.reader("kern.coder_roofline").read(win) \
            == pytest.approx(want)
    assert run.reader("kern.coder_roofline_any").read(
        run.Window(op, files, [], 0, 400)) is None
    assert run.reader("kern.coder_roofline_any").read(
        run.Window("decode", files, ev, 0, 400)) is None


def test_small_run_is_correct(monkeypatch):
    """30,000 binned reads of 151 columns: a 8,192-read warmup shard and
    117 lanes, every payload checked; the encode's counters reach the
    work."""
    from qvz_tpu_torch.pipeline import host
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 8192)
    files = []
    real = encode_binned.run

    def kept(item, cfg, seed, device):
        out = real(item, cfg, seed, device)
        files.append(out[2])
        return out

    monkeypatch.setattr(encode_binned, "run", kept)
    r = run.run_cell(CELL, 3000000019, 0.01, False, device="cpu",
                     log=lambda *a: None,
                     traffic_over={"reads": 30_000, "pool": 2,
                                   "warmup_calls": 1},
                     cfg_over={"warmup_lines": 8192})
    assert r["correct"], r["compared"]
    assert r["compared"] == {"checked_bytes_off": dict(value=0, limit=0)}
    assert r["failed"] == 0 and r["attempted"] >= 1
    for w in files:
        assert w["lines"] == 30_000 and w["columns"] == 151
        assert w["coder_models"] > 0 and w["coder_models_at_risk"] == 0
        assert w["text_bytes"] == 30_000 * 152


def test_control_lower_precision_fails(monkeypatch):
    """The plain reference's View in the program's place, its design in
    float32, the precision below the configuration's float64: bytes off
    at 30,000 x 151 on each of these seeds (146 and more)."""
    from qvz_tpu_torch.pipeline import host
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 8192)

    def control(item, cfg, seed, device):
        view = encode_binned.encode.expected(item, cfg, seed, 7,
                                             dtype=np.float32)
        return view, {}, dict(lines=30_000, columns=151, payload_bytes=0,
                              text_bytes=len(item))

    monkeypatch.setattr(encode_binned, "run", control)
    r = run.run_cell(CELL, 12345678901, 0.01, False, device="cpu",
                     log=lambda *a: None,
                     traffic_over={"reads": 30_000, "pool": 1,
                                   "warmup_calls": 0},
                     cfg_over={"warmup_lines": 8192})
    assert not r["correct"]
    assert r["compared"]["checked_bytes_off"]["value"] > 0
