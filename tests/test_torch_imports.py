"""qvz_tpu_torch stands alone: it imports neither JAX nor anything of
qvz_tpu (only the tests import both), asks for its device explicitly, and
builds its kernels only when a CUDA tensor needs them."""

import ast
import hashlib
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
    from qvz_tpu_torch.parallel.multihost import encode_multihost
    mh, st = encode_multihost(src, n_hosts=2, shards=4,
                              well_state=WellState.debug(), device="cpu")
    assert mh == out.compressed and st["hosts"] == 2
    from qvz_tpu_torch.parallel.mesh import make_mesh
    meshy = encode(data, make_matrix(1), well_state=WellState.debug(),
                   shards=4, mesh=make_mesh(devices=["cpu"] * 2))
    assert meshy.compressed == out.compressed
    from qvz_tpu_torch.tools import transcode
    t2 = td + "/t2"
    assert transcode.main(["transcode", q, t2, "--to", "v2", "--shards",
                           "4"]) == 0
    assert open(t2, "rb").read() == out.compressed
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "qvz_tpu"
             or m.startswith("qvz_tpu."))
assert not bad, bad
print(len(names))
"""


def _port_files():
    root = pathlib.Path(ROOT)
    return (sorted((root / "qvz_tpu_torch").rglob("*.py"))
            + [root / "chip_smoke.py"]
            + [root / "scripts" / f for f in (
                "profile_torch_encode.py", "time_k1_k4.py",
                "compare_torch_e2e.py", "mesh_check_torch.py",
                "sanitize_torch.py")])


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_qvz_tpu(path):
    """No port module, nor chip_smoke.py, nor the port's scripts, imports
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
    decode, the CLI (in process and as python -m qvz_tpu_torch -x), a
    2-host encode (its workers started from the port's launch strings),
    an encode over a mesh of two CPU blocks and a transcode run, and
    neither qvz_tpu nor jax is then in sys.modules."""
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


def test_lineinfo_build_is_a_second_library(monkeypatch, tmp_path):
    """load(lineinfo=True) builds the same sources with -lineinfo added
    (never -G) into a library of its own name; the plain build's flags
    and name stay as they were."""
    assert _build.NVCC_FLAGS == [
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    assert _build.nvcc_flags() == _build.NVCC_FLAGS
    assert _build.nvcc_flags(True) == _build.NVCC_FLAGS + ["-lineinfo"]
    plain, lines = _build.lib_path(), _build.lib_path(lineinfo=True)
    assert plain.parent == lines.parent == _build.BUILD_DIR
    assert plain.name.startswith("libqvz_cuda_") and "lineinfo" not in \
        plain.name
    assert lines.name.startswith("libqvz_cuda_lineinfo_")
    assert plain.stem[-16:] != lines.stem[-16:]
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for src in _build.sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    assert plain.name == f"libqvz_cuda_{h.hexdigest()[:16]}.so"
    # the nvcc commands of each build
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    for lineinfo in (False, True):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.load(lineinfo=lineinfo)
        calls = log.read_text().splitlines()
        log.unlink()
        assert calls and all(("-lineinfo" in c.split()) == lineinfo
                             and "-G" not in c.split() for c in calls)
    # the first load of a process decides the library of every wrapper
    monkeypatch.setattr(_build, "_lib", object())
    monkeypatch.setattr(_build, "_lib_lineinfo", False)
    with pytest.raises(RuntimeError, match="lineinfo"):
        _build.load(lineinfo=True)


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


def test_launch_makes_the_tensors_card_current(monkeypatch):
    """_build.launch calls its library entry with the card of the device
    it is given made current and that card's stream last, and counts the
    launch; a failed launch raises and is not counted."""
    current = []

    class Guard:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + dev.index

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    calls = []

    def entry(*args):
        calls.append((current[-1], args))
        return 0

    card = torch.device("cuda", 3)
    before = _build.LAUNCHES["hist"]
    _build.launch("hist", "histogram kernel", card, entry, 7, 8)
    assert calls == [(card, (7, 8, 1003))] and not current
    assert _build.LAUNCHES["hist"] == before + 1
    with pytest.raises(RuntimeError, match="histogram kernel launch failed"):
        _build.launch("hist", "histogram kernel", card, lambda *a: 700)
    assert _build.LAUNCHES["hist"] == before + 1 and not current


def _wrapper_files():
    root = pathlib.Path(ROOT) / "qvz_tpu_torch"
    return sorted((root / "ops").glob("*.py")) + [root / "microbench.py"]


@pytest.mark.parametrize("path", _wrapper_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_wrappers_launch_on_their_tensors_card(path):
    """Every kernel wrapper launches through _build.launch with the device
    of its tensors (`t.device`, or a name bound to one), never on whatever
    card is current: no library entry but the shared-memory queries is
    called directly."""
    queries = {"qvz_coder_smem_limits", "qvz_decoder_smem_limit"}
    for fn in ast.walk(ast.parse(path.read_text(), str(path))):
        if not isinstance(fn, ast.FunctionDef):
            continue
        bound = {t.id: node.value for node in ast.walk(fn)
                 if isinstance(node, ast.Assign)
                 for t in node.targets if isinstance(t, ast.Name)}
        launched = {}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr.startswith("qvz_"):
                assert node.func.attr in queries, \
                    f"{path.name}:{node.lineno} calls {node.func.attr} directly"
            if node.func.attr == "launch" \
                    and getattr(node.func.value, "id", "") == "_build":
                dev = node.args[2]
                if isinstance(dev, ast.Name):
                    dev = bound.get(dev.id)
                assert isinstance(dev, ast.Attribute) \
                    and dev.attr == "device", \
                    f"{path.name}:{node.lineno} launches off its tensors' card"
                launched[node.args[3].attr] = node.lineno
        for entry in launched:
            assert entry.startswith("qvz_") and entry not in queries
