"""qvz_tpu_torch's multi-host driver on the CPU against qvz_tpu's: the
2-host encode byte-equal at -c 1 and -c 3, the streaming workers' container
and -u file equal, the distributed decode byte-equal, a worker that dies
or ships a short payload failing clean, and the workers importing only
qvz_tpu_torch."""

import glob
import os

import numpy as np
import pytest
import torch

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState as JxWell
from qvz_tpu.parallel import multihost as jx_mh
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.parallel import multihost

DIST = make_matrix(DISTORTION_MSE)


def _write(path, n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    out = np.empty((n, cols + 1), dtype=np.uint8)
    out[:, :cols] = data + 33
    out[:, cols] = 10
    path.write_bytes(out.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def qfile(tmp_path_factory):
    """The 6,000 x 48 input of tests/test_multihost.py."""
    return _write(tmp_path_factory.mktemp("tmh") / "mh.in", 6000, 48, 31)


@pytest.fixture(scope="module")
def stfile(tmp_path_factory):
    """The 30,000 x 40 input of tests/test_streaming.py."""
    return _write(tmp_path_factory.mktemp("tmhs") / "st.in", 30000, 40, 77)


def _both(path, out=None, **kw):
    """qvz_tpu's 2-host encode and the port's; with `out`, each writes
    its container (j.q, p.q) and -u file (j.u, p.u) there."""
    def files(tag):
        if out is None:
            return {}
        return dict(output_path=str(out / f"{tag}.q"),
                    recon_path=str(out / f"{tag}.u"))

    want = jx_mh.encode_multihost(path, n_hosts=2, ratio=0.5,
                                  well_state=JxWell.debug(),
                                  dist_matrix=DIST, **files("j"), **kw)
    got = multihost.encode_multihost(path, n_hosts=2, ratio=0.5,
                                     well_state=WellState.debug(),
                                     dist_matrix=DIST, device="cpu",
                                     **files("p"), **kw)
    return want, got


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_multihost_matches_qvz_tpu(qfile, n_clusters):
    (want, wst), (got, gst) = _both(qfile, shards=6, n_clusters=n_clusters)
    assert got == want
    assert gst["rate"] == wst["rate"]
    assert abs(gst["distortion"] - wst["distortion"]) < 1e-9
    assert gst["hosts"] == 2 and gst["shards"] == wst["shards"]
    # the in-memory workers ran K3's plain version: no kernel launched
    assert gst["worker_launches"] == {"hist": [0, 0]}
    assert set(wst) <= set(gst)


def test_multihost_streaming_matches_qvz_tpu(qfile, tmp_path):
    """Streaming workers, many chunks each, with -u: the same container
    and reconstruction as qvz_tpu's, written straight to disk."""
    kw = dict(shards=5, n_clusters=2, streaming=True, chunk_lines=700)
    want, got = _both(qfile, **kw, out=tmp_path)
    assert want[0] is None and got[0] is None
    assert (tmp_path / "p.q").read_bytes() == (tmp_path / "j.q").read_bytes()
    assert (tmp_path / "p.u").read_bytes() == (tmp_path / "j.u").read_bytes()
    assert got[1]["rate"] == want[1]["rate"]
    assert not glob.glob(str(tmp_path / "qvz_mh_spill_*"))


def test_decode_multihost_matches_qvz_tpu(qfile, tmp_path):
    comp, _ = jx_mh.encode_multihost(qfile, n_hosts=2, shards=5,
                                     n_clusters=2, ratio=0.5,
                                     well_state=JxWell.debug(),
                                     dist_matrix=DIST)
    cpath = tmp_path / "c.q"
    cpath.write_bytes(comp)
    assert jx_mh.decode_multihost(str(cpath), str(tmp_path / "j.dec"),
                                  n_hosts=2) == 6000
    assert multihost.decode_multihost(str(cpath), str(tmp_path / "p.dec"),
                                      n_hosts=2) == 6000
    assert (tmp_path / "p.dec").read_bytes() \
        == (tmp_path / "j.dec").read_bytes()


@pytest.mark.parametrize("chaos,error,match", [
    ("die_on_encode", RuntimeError, r"worker 1 .*coding.*exit code 17"),
    ("truncate_spill", ValueError, "truncated/corrupt payload")])
def test_multihost_fails_clean(stfile, tmp_path, monkeypatch, chaos, error,
                               match):
    """A worker that dies in the coding phase, or ships a spill file 64
    bytes short of its directory entries: the coordinator names the fault
    and leaves no container and no spill directory behind."""
    monkeypatch.setenv("QVZ_MH_CHAOS", chaos)
    opath = tmp_path / "x.q"
    with pytest.raises(error, match=match):
        multihost.encode_multihost(stfile, n_hosts=2, streaming=True,
                                   ratio=0.5, well_state=WellState.debug(),
                                   device="cpu", output_path=str(opath))
    assert not opath.exists()
    assert not glob.glob(os.path.join(str(tmp_path), "qvz_mh_spill_*"))


def test_multihost_on_cuda_without_a_card_raises(qfile):
    """device="cuda" asks for the card before any worker starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.encode_multihost(qfile, n_hosts=2)


def test_worker_launch_strings_import_the_port():
    """The two worker launch strings (the -c code of each worker) import
    qvz_tpu_torch's entry points and nothing of qvz_tpu."""
    import ast
    import inspect
    codes = [node.value for node in ast.walk(ast.parse(
        inspect.getsource(multihost)))
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and node.value.startswith("from ") and " import " in node.value]
    assert sorted(c.split(";")[0] for c in codes) == [
        "from qvz_tpu_torch.parallel.multihost import _decode_worker_main",
        "from qvz_tpu_torch.parallel.multihost import _worker_main"]


def test_workers_start_without_torch():
    """The workers' module imports no torch: a decode or streaming worker
    never needs it, and importing it costs seconds a worker on the card's
    machine (an in-memory worker imports it for its K3 call)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; from qvz_tpu_torch.parallel.multihost import "
         "_worker_main, _decode_worker_main; print('torch' in sys.modules)"],
        cwd=root, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": root + os.pathsep
             + os.environ.get("PYTHONPATH", "")})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
