#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on one NVIDIA GPU.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell names a configuration (configs/<name>.json: the settings and
the shape of the data) and a traffic mix (traffic/<name>.json: the
operation, the file size, the pool of files). Set-up makes a
pool of quality texts on the card from the seed, prepares the
operation's inputs (for a decode, the program's containers of them) and
calls the program on them until every kernel is built and loaded. The
window then calls it on the pool's files in turn, one after another (a
closed loop with one client), for --seconds, and finishes the file in
flight. With --trace 1 the window runs under torch.profiler and the
per-layer metrics are read (metrics/<name>.py, one reader a metric);
with --trace 0 the end-to-end metrics are taken by the host's clock.

After the window the plain reference (reference/, NumPy, nothing of the
program) works out the answer for one file of the pool drawn from the
seed (every byte of its container but the payloads of the lanes that it
does not draw from the seed), and every output of that file in the
window is compared with it;
the numbers compared, each with its limit, are the last lines of
standard error and the last key of the result. The last line of
standard output is the result, one JSON object.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "qvz_tpu")
WINDOW = "port_bench.window"
# the keys a file may hold: each is acted on, here or by the operation
# (its CONFIG_KEYS and TRAFFIC_KEYS), or is text for the reader
TEXT_KEYS = {"name", "source", "precision", "deployment", "assumed", "note"}
CONFIG_KEYS = {"columns", "generator"}
TRAFFIC_KEYS = {"op", "reads", "pool", "warmup_calls", "metric"}


def load_cell(workload: str) -> dict:
    """The cell's entry, its configuration and traffic files, and the
    metrics BENCHMARK.json asks of it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"port_bench: no workload {workload!r} in "
                         "BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    op = operation(traffic["op"])
    _acted_on(cfg, CONFIG_KEYS | op.CONFIG_KEYS, conf["file"])
    _acted_on(traffic, TRAFFIC_KEYS | op.TRAFFIC_KEYS,
              f"traffic/{cell['traffic']}.json")
    for key, value in op.FIXED.items():
        if cfg[key] != value:
            raise SystemExit(f"port_bench: {conf['file']}: {key} "
                             f"{cfg[key]!r}; the harness runs {value!r}")
    return dict(
        cell=cell, cfg=cfg, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def _acted_on(data: dict, keys: set, where: str) -> None:
    """Refuse a file that states a setting the harness does not act on
    (a later file's `clients: 4` would otherwise run one client)."""
    if set(data) - keys - TEXT_KEYS or not set(data) >= keys:
        raise SystemExit(
            f"port_bench: {where}: keys "
            f"{sorted(set(data) - keys - TEXT_KEYS)} are not acted on; "
            f"{sorted(keys - set(data))} are missing")


def reader(name: str):
    """The reader module of a per-layer metric, metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def operation(op: str):
    return importlib.import_module(f"port_bench.ops.{op}")


class Window:
    """What the readers of per-layer metrics read: the window's files
    (their phase seconds and work) and, when traced, the card's
    events."""

    def __init__(self, op: str, files: list, events=None, lo=None,
                 hi=None):
        self.op = op
        self.phases = [f["phases"] for f in files]
        self.work = [f["work"] for f in files]
        self.events = events or []
        self.window_us = (hi - lo) if events is not None else None
        from port_bench import trace
        self.busy_us = trace.busy_us(self.events)

    def phase_ms(self, op: str, phase: str):
        """The phase's mean milliseconds per file, or None."""
        if op != self.op:
            return None
        vals = [p[phase] for p in self.phases if phase in p]
        if not vals or len(vals) != len(self.phases):
            return None
        return 1000.0 * sum(vals) / len(vals)

    def kernel_s(self, names) -> float:
        """Seconds of the card's events whose name holds one of names."""
        return sum(b - a for a, b, n in self.events
                   if any(k in n for k in names)) / 1e6


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cfg_over: dict | None = None,
             traffic_over: dict | None = None, t_start: float | None = None,
             log=None, spec: dict | None = None) -> dict:
    """One run of a cell; returns the result object (its `compared` key
    last). cfg_over and traffic_over replace keys of the configuration
    and the traffic (the tests' small sizes); spec, a cell as
    ``load_cell`` gives it, stands in for BENCHMARK.json's."""
    import numpy as np
    import torch

    from port_bench import inputs
    from port_bench import trace as tr

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = _T0 if t_start is None else t_start
    spec = spec or load_cell(workload)
    cfg = {**spec["cfg"], **(cfg_over or {})}
    traffic = {**spec["traffic"], **(traffic_over or {})}
    op = operation(traffic["op"])
    pool = int(traffic["pool"])
    rng = np.random.default_rng(seed)
    sample = int(rng.integers(pool))
    wseed = inputs.well_seed(seed)

    texts = inputs.make_pool(seed, pool, int(traffic["reads"]),
                             int(cfg["columns"]), cfg["generator"], device)
    if device != "cpu":
        torch.cuda.empty_cache()
    items = op.prepare(texts, cfg, wseed, device)
    for k in range(int(traffic["warmup_calls"])):
        op.run(items[k % pool], cfg, wseed, device)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"port_bench: {workload}: set-up {setup_s:.3f} s")

    files, outputs, failed, errors = [], [], 0, []
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    with prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            end = t0 + seconds
            k = 0
            while True:
                i = k % pool
                a = time.perf_counter()
                try:
                    out, phases, work = op.run(items[i], cfg, wseed, device)
                except Exception:               # a failed call counts
                    failed += 1
                    errors.append(traceback.format_exc())
                    out = None
                b = time.perf_counter()
                if out is not None:
                    files.append(dict(start=a, end=b, phases=phases,
                                      work=work))
                    if i == sample:
                        outputs.append(out)
                k += 1
                if b >= end and k > sample:
                    break
            if device != "cpu":
                torch.cuda.synchronize()
            t_last = time.perf_counter()
    window_s = t_last - t0
    for err in errors[:3]:
        log(err)
    result: dict = dict(correct=False, attempted=k, failed=failed)
    metrics: dict = {}
    units = {m["name"]: m["unit"] for m in
             spec["end_to_end"] + spec["per_layer"]}
    done_bytes = sum(f["work"]["text_bytes"] for f in files)
    if trace:
        lo, hi = tr.cpu_range(prof, WINDOW)
        events = (tr.device_events(prof, lo, hi, skip=(WINDOW,))
                  if device != "cpu" else [])
        win = Window(traffic["op"], files, events, lo, hi)
        for m in spec["per_layer"]:
            v = reader(m["name"]).read(win)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        busy_s = win.busy_us / 1e6
        traced_s = win.window_us / 1e6
        names = tr.by_name(events).most_common(10)
        idle = sorted(tr.gaps(events, lo, hi), reverse=True)[:10]
        breakdown = dict(
            device_ops=[[n, us / 1e6] for n, us in names],
            idle_gaps=[[label, us / 1e6] for us, label in idle])
        del prof, events, win
    else:
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = dict(value=setup_s, unit=units["setup_s"])
            elif m["name"] == traffic["metric"]:
                metrics[m["name"]] = dict(
                    value=done_bytes / window_s / 1e6, unit=m["unit"])
            else:
                raise SystemExit(f"port_bench: {workload} has no reading "
                                 f"of {m['name']}")
    result["metrics"] = metrics
    if device == "cpu":
        dev = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    else:
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=1,
                   memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    if trace:
        dev.update(busy_s=busy_s, window_s=traced_s)
        result["breakdown"] = breakdown
    result["device"] = dev
    log(f"port_bench: {workload}: {len(files)} files in {window_s:.3f} s, "
        f"{failed} failed, {done_bytes / window_s / 1e6:.3f} MB/s of text; "
        "seconds a file: "
        + " ".join(f"{f['end'] - f['start']:.3f}" for f in files))

    # the program's state goes before the reference runs
    text = texts[sample]
    del items, texts
    if device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = op.expected(
        text, cfg, wseed, seed,
        workers=0 if device == "cpu" else os.cpu_count(),
        log=lambda stage, s: log(f"port_bench: reference: {stage} {s:.3f} s"))
    compared = op.compare(outputs, want) if outputs else {}
    ref_s = time.perf_counter() - t
    log(f"port_bench: {workload}: reference {ref_s:.3f} s, file {sample} "
        f"of the pool, {len(outputs)} outputs compared")
    result["reference_s"] = ref_s
    result["correct"] = bool(outputs) and failed == 0 and all(
        v <= lim for v, lim in compared.values())
    result["compared"] = {n: dict(value=v, limit=lim)
                          for n, (v, lim) in compared.items()}
    return result


def _host() -> str:
    cpus = os.cpu_count()
    mine = (len(os.sched_getaffinity(0))
            if hasattr(os, "sched_getaffinity") else cpus)
    try:
        quota = pathlib.Path("/sys/fs/cgroup/cpu.max").read_text().strip()
    except OSError:
        quota = "not read"
    return f"{cpus} CPUs, {mine} for this process, cgroup cpu.max {quota}"


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the run at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    spec = load_cell(args.workload)
    # the warmup shard's cap reaches the program through its environment
    os.environ["QVZ_TPU_WARMUP_LINES"] = str(int(spec["cfg"]["warmup_lines"]))
    import torch
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    print(f"port_bench: card {_power_limit()}; host {_host()}",
          file=sys.stderr)
    bad = sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
    if bad:
        print(f"port_bench: the process holds {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
