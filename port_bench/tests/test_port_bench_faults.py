"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card skipped (device "cpu", the kernels' plain
versions), a small size, and each fault a cell can have planted where
the program's answer is made: an answer altered, half the batch left
out, a step that returns its input unchanged. The control, the plain
reference put in the program's place in the precision below the one
the configuration states (a float32 design), fails too; a sound run
passes."""

import numpy as np
import pytest

from port_bench import run
from port_bench.ops import encode

SMALL = dict(traffic_over={"reads": 1000, "pool": 2, "warmup_calls": 1},
             cfg_over={"columns": 12, "warmup_lines": 256})


@pytest.fixture(autouse=True)
def _small_warmup(monkeypatch):
    from qvz_tpu_torch.pipeline import host
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 256)


# the control needs contexts enough that float32 sums move a decision
CONTROL = dict(traffic_over={"reads": 2000, "pool": 2, "warmup_calls": 1},
               cfg_over={"columns": 20, "warmup_lines": 256})


SEED = 11


def _run(cell, size=SMALL):
    """A run of the cell; "-c 1" runs it with one cluster (the
    reference's default settings, the k-means and the cluster-id
    segment bypassed)."""
    name, _, clusters = cell.partition(" ")
    over = dict(size["cfg_over"])
    if clusters:
        over["clusters"] = int(clusters[-1])
    return run.run_cell(name, SEED, 0.01, False, device="cpu",
                        log=lambda *a: None,
                        traffic_over=size["traffic_over"], cfg_over=over)


def _altered(out):
    b = bytearray(out)
    b[len(b) // 2] ^= 1
    return bytes(b)


FAULTS = {
    "altered": lambda item, out: _altered(out),
    "half": lambda item, out: None,        # half the reads coded
    "unchanged": lambda item, out: item,
}
CELLS = {"c3-encode-10m -c 1": encode, "c3-encode-10m": encode}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_caught(monkeypatch, cell, fault):
    op = CELLS[cell]
    real = op.run

    def broken(item, cfg, seed, device):
        out, phases, work = real(item, cfg, seed, device)
        bad = FAULTS[fault](item, out)
        if bad is None:                    # code only the first half
            half = item[:(len(item) // 2) // 13 * 13]
            bad = real(half, cfg, seed, device)[0]
        return bad, phases, work

    monkeypatch.setattr(op, "run", broken)
    r = _run(cell)
    assert not r["correct"]
    assert max(c["value"] for c in r["compared"].values()) > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_lower_precision_fails(monkeypatch, cell):
    op = CELLS[cell]
    real = op.run

    def control(item, cfg, seed, device):
        _, phases, work = real(item, cfg, seed, device)
        got = op.expected(item, cfg, seed, SEED, dtype=np.float32)
        return got, phases, work

    monkeypatch.setattr(op, "run", control)
    r = _run(cell, size=CONTROL)
    assert not r["correct"]
