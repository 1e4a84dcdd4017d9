"""The port's default container is qvz_tpu's: with no --shards, `python
-m qvz_tpu_torch` writes the reference-compatible v1 container that
`python -m qvz_tpu` writes (and the C reference decodes), and
`api.compress_bytes` returns qvz_tpu.api's bytes."""

import os
import subprocess
import sys

import numpy as np
import qvz_tpu.api as japi

import qvz_tpu_torch.api as tapi
from qvz_tpu_torch.format import container, container_v2

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))


def _run(module, *args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def _is_v1(blob: bytes, lines: int, cols: int) -> bool:
    _, got_cols, got_lines = container.read_header(blob[:9])
    return (not container_v2.is_v2(blob) and got_cols == cols
            and got_lines == lines)


def test_cli_default_writes_qvz_tpus_v1(golden_dir, tmp_path):
    src = golden_dir / "small.in"
    port, ref = tmp_path / "port.q", tmp_path / "ref.q"
    r = _run("qvz_tpu_torch", "--debug-seed", "--device", "cpu", str(src),
             str(port), cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    r = _run("qvz_tpu", "--debug-seed", str(src), str(ref), cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    blob = port.read_bytes()
    assert blob == ref.read_bytes()
    rows = src.read_bytes().count(b"\n")
    cols = src.read_bytes().index(b"\n")
    assert _is_v1(blob, rows, cols)
    # the C reference's own container for these defaults (-f 0.5, MSE, -c 1)
    assert blob == (golden_dir / "f05_mse.q").read_bytes()


def test_api_default_gives_qvz_tpus_bytes(golden_dir):
    rng = np.random.default_rng(5)
    q = np.clip(rng.integers(28, 40, size=(700, 1))
                + rng.integers(-2, 3, size=(700, 24)).cumsum(1), 2, 41)
    data = np.concatenate([q.astype(np.uint8) + 33,
                           np.full((700, 1), 10, np.uint8)], 1).tobytes()
    got, _ = tapi.compress_bytes(data, debug_seed=True, device="cpu")
    want, _ = japi.compress_bytes(data, debug_seed=True)
    assert got == want
    assert _is_v1(got, 700, 24)
