"""BENCHMARK.json, and every configuration, traffic mix, operation and
metric reader it names, load by name and keep to the contract's form."""

import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_loads(conf):
    assert NAME.match(conf["name"])
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert conf["file"].startswith("port_bench/")
    assert 0 < len(conf["source"]) <= 200 and 0 < len(conf["why"]) <= 200
    for key in ("columns", "ratio", "clusters", "cluster_threshold",
                "shards", "prime", "warmup_lines", "generator"):
        assert key in data


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_loads(cell):
    from port_bench import run
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 0 < len(cell["why"]) <= 200
    spec = run.load_cell(cell["name"])
    run.operation(spec["traffic"]["op"])
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["traffic"]["metric"] in names
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert hasattr(run.reader(m["name"]), "read")


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    cells = {w["name"] for w in SPEC["workloads"]}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moves = {m["name"] for m in SPEC["end_to_end"]}
        assert metric["moves"] in moves and metric["layer"]
        for cell in metric.get("workloads", []):
            e2e = [m for m in SPEC["end_to_end"]
                   if m["name"] == metric["moves"]]
            assert cell in e2e[0].get("workloads", [cell])


@pytest.mark.parametrize("change", ["unknown", "missing", "none"])
def test_a_key_not_acted_on_is_refused(change):
    """A traffic file that states a setting nothing acts on (a later
    file's `clients: 4`), or lacks one, stops the run."""
    from port_bench import run
    from port_bench.ops import encode
    traffic = json.loads((ROOT / "port_bench/traffic/encode-10m.json")
                         .read_text())
    if change == "unknown":
        traffic["clients"] = 4
    elif change == "missing":
        del traffic["pool"]
    keys = run.TRAFFIC_KEYS | encode.TRAFFIC_KEYS
    if change == "none":
        run._acted_on(traffic, keys, "traffic")
    else:
        with pytest.raises(SystemExit):
            run._acted_on(traffic, keys, "traffic")
