"""qvz_tpu_torch.tools against qvz_tpu.tools: the container transcoder
(v1 <-> QVZ2 without requantization) byte-equal to direct encodes and to
qvz_tpu's transcoder, the runtime's line-order coder byte-equal to
qvz_tpu's, the FASTQ tool and the distortion checker, and their
``python -m`` entries."""

import os
import subprocess
import sys

import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu.native import runtime as jrt
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState as JWell
from qvz_tpu.pipeline import encode as host_encode
from qvz_tpu.tools import mse_check as jmse
from qvz_tpu.tools import transcode as jtc
from qvz_tpu_torch import cli
from qvz_tpu_torch.native import runtime as trt
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host as port_host
from qvz_tpu_torch.tools import fastq, mse_check
from qvz_tpu_torch.tools import transcode as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST = make_matrix(DISTORTION_MSE)


def _data(n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.fixture(autouse=True)
def small_warmup(monkeypatch):
    """A 512-line warmup shard in both packages, so the QVZ2 plans prime."""
    monkeypatch.setattr(host_encode, "PRIME_WARMUP_LINES", 512)
    monkeypatch.setattr(port_host, "PRIME_WARMUP_LINES", 512)


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """For k = 1 and 3: the port's host-engine v1 and QVZ2 (4 shards,
    primed) containers of one input, written to files."""
    data = _data(6000, 20, seed=55)
    d = tmp_path_factory.mktemp("tc")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_host, "PRIME_WARMUP_LINES", 512)
        for k in (1, 3):
            kw = dict(n_clusters=k, ratio=0.5, want_recon=False)
            v1 = port_host.encode(data, DIST, shards=1,
                                  well_state=WellState.debug(), **kw)
            v2 = port_host.encode(data, DIST, shards=4,
                                  well_state=WellState.debug(), **kw)
            p1, p2 = d / f"c{k}.v1.q", d / f"c{k}.v2.q"
            p1.write_bytes(v1.compressed)
            p2.write_bytes(v2.compressed)
            out[k] = (p1, v1.compressed, p2, v2.compressed)
    return data, out


@pytest.mark.parametrize("k", [1, 3])
def test_v1_to_v2_byte_equal_direct(encoded, tmp_path, k):
    _, enc = encoded
    p1, _, _, v2_direct = enc[k]
    got, want = tmp_path / "t.v2.q", tmp_path / "j.v2.q"
    tc.transcode(str(p1), str(got), "v2", shards=4)
    jtc.transcode(str(p1), str(want), "v2", shards=4)
    assert got.read_bytes() == v2_direct
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("k", [1, 3])
def test_v2_to_v1_byte_equal_direct(encoded, tmp_path, k):
    _, enc = encoded
    _, v1_direct, p2, _ = enc[k]
    got, want = tmp_path / "t.v1.q", tmp_path / "j.v1.q"
    tc.transcode(str(p2), str(got), "v1")
    jtc.transcode(str(p2), str(want), "v1")
    assert got.read_bytes() == v1_direct
    assert got.read_bytes() == want.read_bytes()


def test_v1_to_v2_default_shards_is_the_device_lane_count(tmp_path):
    """--shards 0 means what the port's CLI means by it: the device lane
    count, so a transcoded v1 container equals the port's default
    encode."""
    data = _data(3000, 6, seed=8)
    v1 = tmp_path / "v1.q"
    v1.write_bytes(port_host.encode(data, DIST, shards=1,
                                    well_state=WellState.debug()).compressed)
    got = tmp_path / "v2.q"
    tc.transcode(str(v1), str(got), "v2")
    direct = port.encode(data, DIST, well_state=WellState.debug(),
                         want_recon=False, device="cpu")
    assert port.device_lane_count(3000) == 16
    assert got.read_bytes() == direct.compressed


@pytest.mark.parametrize("k", [1, 3])
def test_encode_lines_matches_qvz_tpu(k):
    data = _data(900, 11, seed=k)
    clusters = ((np.arange(900) % k).astype(np.uint8) if k > 1 else None)
    c0, cond = jrt.stats_host(data, clusters, k)
    draws = jrt.well_draws7(JWell.debug().state, data.size).reshape(
        data.shape)
    jtab = jrt.Design(c0, cond, MODE_RATIO, 0.5, DIST).tables()
    ttab = trt.Design(c0, cond, MODE_RATIO, 0.5, DIST).tables()
    model_ids, syms, _ = jrt.quantize(jtab, data, clusters, draws)
    want = jrt.encode_lines(jtab, clusters, model_ids, syms)
    assert trt.encode_lines(ttab, clusters, model_ids, syms) == want
    assert len(want) > 0


def test_transcode_cli(tmp_path):
    data = _data(4000, 25, seed=2)
    inp = tmp_path / "t.in"
    inp.write_bytes(np.concatenate(
        [data + 33, np.full((4000, 1), 10, np.uint8)], 1).tobytes())
    v1 = tmp_path / "t.v1.q"
    assert cli.main(["qvz_tpu_torch", "-f", "0.5", "--debug-seed",
                     "--shards", "1", "--device", "cpu", str(inp),
                     str(v1)]) == 0
    v2 = tmp_path / "t.v2.q"
    assert tc.main(["transcode", str(v1), str(v2), "--to", "v2",
                    "--shards", "3"]) == 0
    back = tmp_path / "t.back.q"
    assert tc.main(["transcode", str(v2), str(back), "--to", "v1"]) == 0
    assert back.read_bytes() == v1.read_bytes()
    want = tmp_path / "j.v2.q"
    assert jtc.main(["transcode", str(v1), str(want), "--to", "v2",
                     "--shards", "3"]) == 0
    assert v2.read_bytes() == want.read_bytes()
    assert tc.main(["transcode", str(v1)]) == 1      # usage
    assert tc.main(["transcode", str(tmp_path / "none.q"), str(back),
                    "--to", "v1"]) == 1


@pytest.fixture()
def fastq_file(tmp_path):
    rng = np.random.default_rng(3)
    quals = (rng.integers(0, 72, size=(50, 30)).astype(np.uint8) + 33)
    fq = tmp_path / "t.fastq"
    with open(fq, "wb") as f:
        for i, q in enumerate(quals):
            f.write(b"@read%d comment\n" % i)
            f.write(b"ACGT" * 7 + b"AC\n")
            f.write(b"+\n")
            f.write(q.tobytes() + b"\n")
    return fq, quals


def test_fastq_round_trip(fastq_file, tmp_path):
    fq, quals = fastq_file
    qual = tmp_path / "q.txt"
    assert fastq.extract(str(fq), str(qual)) == 50
    got = np.frombuffer(qual.read_bytes(), dtype=np.uint8).reshape(50, 31)
    assert np.array_equal(got[:, :30], quals)
    out = tmp_path / "r.fastq"
    assert fastq.reinsert(str(fq), str(qual), str(out)) == 50
    assert out.read_bytes() == fq.read_bytes()


def test_fastq_reinsert_length_mismatch(fastq_file, tmp_path):
    fq, _ = fastq_file
    bad = tmp_path / "bad.txt"
    bad.write_bytes(b"II\n" * 50)
    with pytest.raises(ValueError, match="length mismatch"):
        fastq.reinsert(str(fq), str(bad), str(tmp_path / "o.fastq"))


def test_mse_check_compare():
    a = np.array([[10, 20], [30, 40]], dtype=np.uint8)
    b = np.array([[12, 20], [30, 37]], dtype=np.uint8)
    r = mse_check.compare(a, b, make_matrix(DISTORTION_MSE))
    assert r["total"] == 4 + 9
    assert r["stats_line"] == ((4 / 2) + (9 / 2)) / 2
    rng = np.random.default_rng(4)
    x, y = (rng.integers(0, 72, size=(40, 9)).astype(np.uint8)
            for _ in range(2))
    for kind in (1, 2, 3):
        assert mse_check.compare(x, y, make_matrix(kind)) \
            == jmse.compare(x, y, make_matrix(kind))
    with pytest.raises(ValueError, match="geometry"):
        mse_check.compare(a, b[:1], make_matrix(DISTORTION_MSE))


def test_python_m_entries(fastq_file, tmp_path):
    """python -m qvz_tpu_torch.tools.<name> runs each tool, as qvz_tpu's
    entries do; mse_check prints qvz_tpu's line."""
    fq, _ = fastq_file
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    qual = tmp_path / "q.txt"

    def run(*args):
        return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=120)

    r = run("qvz_tpu_torch.tools.fastq", "extract", str(fq), str(qual))
    assert r.returncode == 0 and "extracted 50" in r.stdout
    lossy = tmp_path / "l.txt"
    lossy.write_bytes(qual.read_bytes().replace(b"I", b"H"))
    r = run("qvz_tpu_torch.tools.mse_check", "-d", "L", str(qual),
            str(lossy))
    want = run("qvz_tpu.tools.mse_check", "-d", "L", str(qual), str(lossy))
    assert r.returncode == 0 and r.stdout == want.stdout
    assert run("qvz_tpu_torch.tools.transcode", str(qual)).returncode == 1
