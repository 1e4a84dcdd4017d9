"""qvz_tpu_torch stands alone: it imports neither JAX nor anything of
qvz_tpu (only the tests import both), asks for its device explicitly, and
builds its kernels only when a CUDA tensor needs them."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from qvz_tpu_torch import _build, device

ROOT = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))

_STANDALONE = r"""
import importlib, pkgutil, subprocess, sys, tempfile
import numpy as np
import qvz_tpu_torch
names = [m.name for m in pkgutil.walk_packages(qvz_tpu_torch.__path__,
                                                "qvz_tpu_torch.")
         if m.name != "qvz_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
from qvz_tpu_torch import cli
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline import host
from qvz_tpu_torch.pipeline.decode import decode
from qvz_tpu_torch.pipeline.encode import encode
rng = np.random.default_rng(0)
data = rng.integers(20, 30, size=(64, 5)).astype(np.uint8)
out = encode(data, make_matrix(1), well_state=WellState.debug(), shards=4,
             device="cpu")
st = {}
dec = decode(out.compressed, device="cpu", stats=st)
assert (dec[:, :5] == out.reconstructed + 33).all() and st["lanes"] == 4
ref = host.encode(data, make_matrix(1), well_state=WellState.debug(),
                  shards=4)
assert ref.compressed == out.compressed
v1 = host.encode(data, make_matrix(1), well_state=WellState.debug())
assert (decode(v1.compressed, device="cpu") == dec).all()
with tempfile.TemporaryDirectory() as td:
    src, q, x = td + "/in", td + "/q", td + "/x"
    open(src, "wb").write(np.concatenate(
        [data + 33, np.full((64, 1), 10, np.uint8)], 1).tobytes())
    assert cli.main(["qvz_tpu_torch", "--debug-seed", "--shards", "1",
                     "--device", "cpu", src, q]) == 0
    assert cli.main(["qvz_tpu_torch", "-x", "--device", "cpu", q, x]) == 0
    assert open(x, "rb").read() == dec.tobytes()
    r = subprocess.run([sys.executable, "-m", "qvz_tpu_torch", "-x",
                        "--device", "cpu", q, x])
    assert r.returncode == 0 and open(x, "rb").read() == dec.tobytes()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "qvz_tpu"
             or m.startswith("qvz_tpu."))
assert not bad, bad
print(len(names))
"""


def _port_files():
    root = pathlib.Path(ROOT)
    return (sorted((root / "qvz_tpu_torch").rglob("*.py"))
            + [root / "chip_smoke.py",
               root / "scripts" / "profile_torch_encode.py"])


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_qvz_tpu(path):
    """No port module, nor chip_smoke.py, nor the profile script, imports
    qvz_tpu or qvz_tpu.* (nor JAX), at any depth of the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("qvz_tpu", "jax"), \
                f"{path.name}:{node.lineno} imports {mod}"


def test_port_never_imports_jax():
    """Every port module, the device and host encode and decode, a v1
    decode and the CLI (in process and as python -m qvz_tpu_torch -x)
    run, and neither qvz_tpu nor jax is then in sys.modules."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", _STANDALONE], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 20    # every module was imported


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
    from qvz_tpu_torch.ops import decoder_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder_device.decode_lanes(None, [], None, None, [])  # the default
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


def test_host_runtime_is_built_into_the_repository():
    from qvz_tpu_torch import native
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == pathlib.Path(ROOT) / "build" / "native"
    assert path.name.startswith("libqvz_rt_") and path.suffix == ".so"
    assert len(path.stem.rsplit("_", 1)[1]) == 16
    # the flags that decide the codebook's double sums, as qvz_tpu's
    assert "-ffp-contract=off" in native.CXXFLAGS
    assert "-march=native" not in native.CXXFLAGS


def test_host_runtime_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises; nothing falls back to another library."""
    from qvz_tpu_torch import native
    monkeypatch.setattr(native, "CXXFLAGS",
                        native.CXXFLAGS + ["-fno-such-flag-qvz"])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not list((tmp_path / "native").glob("*.so"))
