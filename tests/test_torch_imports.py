"""qvz_tpu_torch imports no JAX, asks for its device explicitly, and
builds its kernels only when a CUDA tensor needs them."""

import os
import subprocess
import sys

import pytest
import torch

from qvz_tpu_torch import _build, device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import importlib, pkgutil, sys
import numpy as np
import qvz_tpu_torch
names = [m.name for m in pkgutil.walk_packages(qvz_tpu_torch.__path__,
                                                "qvz_tpu_torch.")
         if m.name != "qvz_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu_torch.pipeline.decode import decode
from qvz_tpu_torch.pipeline.encode import encode
rng = np.random.default_rng(0)
data = rng.integers(20, 30, size=(64, 5)).astype(np.uint8)
out = encode(data, make_matrix(1), well_state=WellState.debug(), shards=4,
             device="cpu")
assert len(out.compressed) > 0
st = {}
dec = decode(out.compressed, device="cpu", stats=st)
assert (dec[:, :5] == out.reconstructed + 33).all() and st["lanes"] == 4
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print(len(names))
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 11    # every module was imported


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from qvz_tpu_torch.pipeline.encode import encode
        import numpy as np
        encode(np.zeros((8, 2), np.uint8), np.zeros((72, 72)), shards=2,
               device="cuda")
    from qvz_tpu_torch.pipeline import decode
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.decode(b"QVZ2", device="cuda")
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")


def _small_container():
    import numpy as np
    from qvz_tpu.ops.distortion import make_matrix
    from qvz_tpu.ops.well import WellState
    from qvz_tpu.pipeline.encode import encode
    data = np.random.default_rng(1).integers(20, 40, size=(600, 6))
    return encode(data.astype(np.uint8), make_matrix(1),
                  well_state=WellState.debug(), use_jax=False, shards=4,
                  prime=False).compressed


@pytest.mark.cuda
def test_cuda_decode_runs_the_kernel():
    """decode(device="cuda") launches K5 on the card, not the CPU plain
    version, and gives the host decoder's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    import numpy as np
    from qvz_tpu.pipeline import decode as host_decode
    from qvz_tpu_torch.pipeline import decode
    comp = _small_container()
    before = _build.LAUNCHES["decoder"]
    got = decode.decode(comp, device="cuda")
    assert _build.LAUNCHES["decoder"] == before + 1
    assert np.array_equal(got, host_decode.decode(comp))


def test_kernel_library_is_keyed_by_source_hash():
    path = _build.lib_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libqvz_cuda_") and path.suffix == ".so"
    assert len(path.stem.rsplit("_", 1)[1]) == 16
    assert {s.name for s in _build.sources()} >= {"quantize.cu", "coder.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_failure_raises(monkeypatch, tmp_path):
    """Without nvcc (or with a failing one) the build raises; it never
    falls back to the plain versions."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'nvcc: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load()
    assert not list((tmp_path / "kernels").glob("*.so"))
