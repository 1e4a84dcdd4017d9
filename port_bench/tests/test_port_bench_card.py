"""A small run of every cell on the card, through the harness as a run
makes it (the kernels built and launched): correct, with every metric
the cell asks for. Skips where no CUDA device is visible."""

import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(monkeypatch, cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    from port_bench import run
    from qvz_tpu_torch.pipeline import host
    monkeypatch.setattr(host, "PRIME_WARMUP_LINES", 256)
    r = run.run_cell(cell, 7, 0.5, trace, device="cuda",
                     traffic_over={"reads": 4000, "pool": 2,
                                   "warmup_calls": 1},
                     cfg_over={"columns": 20, "warmup_lines": 256},
                     log=lambda *a: None)
    assert r["correct"], r["compared"]
    spec = run.load_cell(cell)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert {m["name"] for m in want} <= set(r["metrics"])
