"""qvz_tpu_torch's QVZ2 encode on the CPU (the kernels' plain versions)
against qvz_tpu: containers byte-equal to the device-coder path and the
host path for pinned shard counts, priming on and off, one cluster and
-c 3/-c 4; reconstructions equal to the C reference's golden .u files;
the CLI round trips."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops import stats as jx_stats
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline import decode as host_decode
from qvz_tpu.pipeline import encode as host_encode
from qvz_tpu.spec.pipeline import load_quality_file
from qvz_tpu_torch import cli
from qvz_tpu_torch.ops import stats as tstats
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host as port_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST = make_matrix(DISTORTION_MSE)


def _data(n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.fixture
def small_warmup(monkeypatch):
    """Prime with a 512-line warmup shard in both packages, so a small
    input primes."""
    monkeypatch.setattr(host_encode, "PRIME_WARMUP_LINES", 512)
    monkeypatch.setattr(port_host, "PRIME_WARMUP_LINES", 512)
    monkeypatch.setenv("QVZ_TPU_DEVICE_MIN_BYTES", "0")


def _jax_encode(data, use_jax, **kw):
    return host_encode.encode(data, DIST, well_state=WellState.debug(),
                              use_jax=use_jax, **kw)


@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
@pytest.mark.parametrize("shards", [4, 8, 64])
def test_encode_matches_qvz_tpu(small_warmup, shards, prime):
    data = _data(1300, 8, seed=shards)
    got = port.encode(data, DIST, well_state=WellState.debug(),
                      shards=shards, prime=prime, device="cpu")
    dev = _jax_encode(data, True, shards=shards, prime=prime)
    host = _jax_encode(data, False, shards=shards, prime=prime)
    assert got.compressed == dev.compressed
    assert got.compressed == host.compressed
    assert np.array_equal(got.reconstructed, host.reconstructed)
    out = host_decode.decode(got.compressed)
    assert np.array_equal(out[:, :8], got.reconstructed + 33)
    assert got.stats.rate == host.stats.rate
    # the same float64 sum as qvz_tpu's device path; the host sums per
    # line, in another order
    assert got.stats.distortion == dev.stats.distortion
    assert got.stats.distortion == pytest.approx(host.stats.distortion,
                                                 rel=1e-12)
    assert got.stats.coder_fallback_lanes == 0
    for phase in ("h2d", "stats", "design", "draws", "quantize",
                  "device_code", "d2h", "code"):
        assert got.stats.phase_seconds[phase] >= 0.0, phase


def test_shards_zero_picks_the_device_lane_count(small_warmup):
    """--shards 0 takes the device coder's lane count, so the container
    equals qvz_tpu's device path with shards=0."""
    data = _data(1600, 6, seed=3)
    got = port.encode(data, DIST, well_state=WellState.debug(), shards=0,
                      device="cpu", want_recon=False)
    dev = _jax_encode(data, True, shards=0)
    assert got.compressed == dev.compressed
    # float32 sums per column on both sides, in different orders
    assert got.stats.distortion == pytest.approx(dev.stats.distortion,
                                                 rel=1e-6)


# golden name, input, shards (pinned so the plain coder's step loop stays
# short: med.in primes with the default 8192-line warmup)
GOLDEN = [("tiny_f05", "tiny.in", 8), ("f05_mse", "small.in", 64),
          ("med_f05", "med.in", 200)]


@pytest.mark.parametrize("name,inp,shards", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_recon_equals_golden(golden_dir, name, inp, shards):
    data = load_quality_file(str(golden_dir / inp))
    got = port.encode(data, DIST, mode=MODE_RATIO, ratio=0.5,
                      well_state=WellState.debug(), shards=shards,
                      device="cpu")
    golden_u = (golden_dir / f"{name}.u").read_bytes()
    recon = np.frombuffer(golden_u, np.uint8).reshape(
        data.shape[0], data.shape[1] + 1)[:, :-1] - 33
    assert np.array_equal(got.reconstructed, recon)
    dist = (golden_dir / f"{name}.stats").read_text().split(",")[3]
    assert f"{got.stats.distortion:.4f}" == dist.strip()
    host = _jax_encode(data, False, shards=shards)
    assert got.compressed == host.compressed
    out = host_decode.decode(got.compressed)
    assert out.tobytes() == golden_u


@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
@pytest.mark.parametrize("shards", [8, 64])
@pytest.mark.parametrize("n_clusters", [3, 4])
def test_clustered_encode_matches_qvz_tpu(small_warmup, n_clusters, shards,
                                          prime):
    data = _data(1300, 8, seed=shards + n_clusters)
    kw = dict(n_clusters=n_clusters, cluster_threshold=4.0, shards=shards,
              prime=prime)
    got = port.encode(data, DIST, well_state=WellState.debug(),
                      device="cpu", **kw)
    host = _jax_encode(data, False, **kw)
    assert got.compressed == host.compressed
    assert np.array_equal(got.clusters, host.clusters)
    assert len(np.unique(got.clusters)) == n_clusters
    assert np.array_equal(got.reconstructed, host.reconstructed)
    out = host_decode.decode(got.compressed)
    assert np.array_equal(out[:, :8], got.reconstructed + 33)
    assert got.stats.rate == host.stats.rate
    assert f"{got.stats.distortion:.4f}" == f"{host.stats.distortion:.4f}"
    assert got.stats.phase_seconds["cluster"] > 0.0
    assert got.stats.device_seconds["cluster"] > 0.0


def test_clustered_encode_matches_device_path(small_warmup):
    """-c 3 -T 0 against qvz_tpu's device path (XLA k-means, statistics,
    quantize and lane coder), with --shards 0."""
    data = _data(1000, 36, seed=9)
    kw = dict(n_clusters=3, cluster_threshold=0.0, shards=0)
    got = port.encode(data, DIST, well_state=WellState.debug(),
                      device="cpu", want_recon=False, **kw)
    dev = _jax_encode(data, True, want_recon=False, **kw)
    assert got.compressed == dev.compressed
    assert np.array_equal(got.clusters, dev.clusters)


# golden name, input, clusters, ratio, shards
GOLDEN_CLUSTERED = [("c3_f05", "small.in", 3, 0.5, 64),
                    ("med_c4", "med.in", 4, 0.4, 200)]


@pytest.mark.parametrize("name,inp,n_clusters,ratio,shards",
                         GOLDEN_CLUSTERED,
                         ids=[g[0] for g in GOLDEN_CLUSTERED])
def test_clustered_recon_equals_golden(golden_dir, name, inp, n_clusters,
                                       ratio, shards):
    data = load_quality_file(str(golden_dir / inp))
    got = port.encode(data, DIST, n_clusters=n_clusters, mode=MODE_RATIO,
                      ratio=ratio, well_state=WellState.debug(),
                      shards=shards, device="cpu")
    golden_u = (golden_dir / f"{name}.u").read_bytes()
    recon = np.frombuffer(golden_u, np.uint8).reshape(
        data.shape[0], data.shape[1] + 1)[:, :-1] - 33
    assert np.array_equal(got.reconstructed, recon)
    dist = (golden_dir / f"{name}.stats").read_text().split(",")[3]
    assert f"{got.stats.distortion:.4f}" == dist.strip()
    host = _jax_encode(data, False, n_clusters=n_clusters, ratio=ratio,
                       shards=shards)
    assert got.compressed == host.compressed
    assert host_decode.decode(got.compressed).tobytes() == golden_u


def test_cli_clustered_round_trip(golden_dir, tmp_path):
    src = golden_dir / "small.in"
    q, u, x = tmp_path / "out.q", tmp_path / "recon.u", tmp_path / "dec"
    r = _cli("-f", "0.5", "-c", "3", "-T", "4", "--shards", "8",
             "--debug-seed", "--device", "cpu", "-s", "-u", str(u),
             str(src), str(q), cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    golden = (golden_dir / "c3_f05.stats").read_text().split(",")
    assert r.stdout.split(",")[3] == golden[3]
    assert cli.main(["qvz_tpu_torch", "-x", "--device", "cpu", str(q),
                     str(x)]) == 0
    assert x.read_bytes() == u.read_bytes()
    assert u.read_bytes() == (golden_dir / "c3_f05.u").read_bytes()
    host = _jax_encode(load_quality_file(str(src)), False, n_clusters=3,
                       shards=8)
    assert q.read_bytes() == host.compressed


def test_conditional_counts_match_jax_and_host():
    data = _data(3000, 9, seed=4)
    clusters = (np.arange(3000) % 3).astype(np.uint8)
    c0, cond = tstats.conditional_counts(torch.from_numpy(data),
                                         torch.from_numpy(clusters), 3)
    assert c0.dtype == cond.dtype == torch.int64
    assert cond.shape == (3, 8, 72, 72)
    j0, jc = jx_stats.conditional_counts(data, clusters, 3)
    h0, hc = rt.stats_host(data, clusters, 3)
    for a, b in ((j0, c0), (jc, cond), (h0, c0), (hc, cond)):
        assert np.array_equal(np.asarray(a), b.numpy())
    one = tstats.conditional_counts(torch.from_numpy(data[:, :1]), None, 1)
    assert one[1].shape == (1, 0, 72, 72)
    assert np.array_equal(one[0].numpy()[0],
                          np.bincount(data[:, 0], minlength=72))


@pytest.mark.parametrize("kw", [dict(reuse_blocks=b"")], ids=["reuse"])
def test_outside_the_slice_raises(kw):
    """reuse_blocks is ported: empty blocks are refused as malformed."""
    data = _data(100, 4, seed=1)
    with pytest.raises(ValueError, match="malformed codebook blocks"):
        port.encode(data, DIST, device="cpu", **kw)


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_v1_encode_matches_qvz_tpu(n_clusters):
    """shards=1: the device statistics (and k-means), then the host
    engine codes the single-stream v1 container, as qvz_tpu's device
    path does."""
    data = _data(1300, 8, seed=12 + n_clusters)
    kw = dict(n_clusters=n_clusters, shards=1)
    got = port.encode(data, DIST, well_state=WellState.debug(),
                      device="cpu", **kw)
    assert got.compressed == _jax_encode(data, True, **kw).compressed
    host = _jax_encode(data, False, **kw)
    assert got.compressed == host.compressed
    assert np.array_equal(got.reconstructed, host.reconstructed)
    assert got.stats.rate == host.stats.rate
    assert f"{got.stats.distortion:.4f}" == f"{host.stats.distortion:.4f}"
    assert np.array_equal(host_decode.decode(got.compressed)[:, :8],
                          got.reconstructed + 33)


def test_cli_decode_matches_qvz_tpu(small_warmup, tmp_path):
    """Encode with the port, decode with -x --device cpu (the lanes on
    K5's plain version): the bytes of python -m qvz_tpu -x, and of the
    API."""
    from qvz_tpu_torch import api

    data = _data(1300, 8, seed=14)
    src, q = tmp_path / "in", tmp_path / "out.q"
    src.write_bytes(np.concatenate(
        [data + 33, np.full((1300, 1), 10, np.uint8)], 1).tobytes())
    for kw in (["--shards", "8"], ["--shards", "6", "-c", "3",
                                    "--no-prime"]):
        assert cli.main(["qvz_tpu_torch", *kw, "--debug-seed", "--device",
                         "cpu", str(src), str(q)]) == 0
        x, y = tmp_path / "port.dec", tmp_path / "host.dec"
        assert cli.main(["qvz_tpu_torch", "-x", "--device", "cpu", str(q),
                         str(x)]) == 0
        r = _cli("-x", str(q), str(y), cwd=tmp_path, module="qvz_tpu")
        assert r.returncode == 0, r.stdout + r.stderr
        assert x.read_bytes() == y.read_bytes()
        assert api.decompress_bytes(q.read_bytes(), device="cpu") \
            == x.read_bytes()
        assert api.decompress(str(q), str(y), device="cpu") == 1300
        assert y.read_bytes() == x.read_bytes()


def _cli(*args, cwd, module="qvz_tpu_torch"):
    return subprocess.run([sys.executable, "-m", module, *args],
                          cwd=cwd, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": ROOT + os.pathsep
                               + os.environ.get("PYTHONPATH", "")})


def test_cli_round_trip(golden_dir, tmp_path):
    src = golden_dir / "small.in"
    q, u, x = tmp_path / "out.q", tmp_path / "recon.u", tmp_path / "dec"
    r = _cli("-f", "0.5", "-c", "1", "--shards", "8", "--debug-seed",
             "--device", "cpu", "-s", "-u", str(u), str(src), str(q),
             cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert re.fullmatch(
        r"rate, \d+\.\d{4}, distortion, \d+\.\d{4}, time, \d+\.\d{4}, "
        r"size, \d+ \n", r.stdout)
    assert cli.main(["qvz_tpu_torch", "-x", "--device", "cpu", str(q),
                     str(x)]) == 0
    assert x.read_bytes() == u.read_bytes()
    assert u.read_bytes() == (golden_dir / "f05_mse.u").read_bytes()
    host = _jax_encode(load_quality_file(str(src)), False, shards=8)
    assert q.read_bytes() == host.compressed


def _run_cli(mod, *args) -> tuple[int, str]:
    """One in-process run of a CLI's main; returns (rc, stdout)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([mod.__name__, *args])
    return rc, buf.getvalue()


def _s_line(out: str) -> list[str]:
    """The -s line's rate, distortion and size (not its time)."""
    f = [x.strip() for x in out.strip().splitlines()[-1].split(",")]
    assert f[0] == "rate" and f[2] == "distortion" and f[6] == "size", out
    return [f[1], f[3], f[7]]


@pytest.fixture(scope="module")
def cli_input(tmp_path_factory):
    """1,500 x 16 reads as a quality file."""
    path = tmp_path_factory.mktemp("cli") / "in"
    path.write_bytes(np.concatenate(
        [_data(1500, 16, seed=21) + 33, np.full((1500, 1), 10, np.uint8)],
        1).tobytes())
    return path


def test_cli_streaming_matches_qvz_tpu(cli_input, tmp_path):
    """--streaming: the container and -s line of qvz_tpu's --streaming
    (its host legs) for the same shard count, and -u equal."""
    from qvz_tpu import cli as jx_cli
    flags = ["-f", "0.5", "-c", "2", "--shards", "6", "--debug-seed", "-s",
             "--streaming"]
    rc, out = _run_cli(cli, *flags, "--device", "cpu", "-u",
                       str(tmp_path / "p.u"), str(cli_input),
                       str(tmp_path / "p.q"))
    assert rc == 0, out
    jrc, jout = _run_cli(jx_cli, *flags, "-u", str(tmp_path / "j.u"),
                         str(cli_input), str(tmp_path / "j.q"))
    assert jrc == 0, jout
    assert (tmp_path / "p.q").read_bytes() == (tmp_path / "j.q").read_bytes()
    assert (tmp_path / "p.u").read_bytes() == (tmp_path / "j.u").read_bytes()
    assert _s_line(out) == _s_line(jout)


@pytest.mark.parametrize("extra,streams", [
    (["--shards", "0"], True), (["--shards", "1"], False),
    (["--shards", "0", "-u", "recon"], False), ([], False)],
    ids=["auto", "shards1", "recon", "default"])
def test_cli_auto_streaming(cli_input, tmp_path, monkeypatch, extra,
                            streams):
    """At QVZ_TPU_STREAM_MIN_BYTES or more a QVZ2 encode streams, as
    qvz_tpu's does; never at --shards 1 (the v1 container, the default)
    or with -u. Either way the container is the in-memory encode's."""
    monkeypatch.setenv("QVZ_TPU_STREAM_MIN_BYTES", "1000")
    monkeypatch.chdir(tmp_path)
    args = ["-v", "--debug-seed", "--device", "cpu", *extra]
    rc, out = _run_cli(cli, *args, str(cli_input), "a.q")
    assert rc == 0, out
    assert ("Streaming encode:" in out) == streams
    monkeypatch.setenv("QVZ_TPU_STREAM_MIN_BYTES", str(1 << 40))
    # the streamed plan at --shards 0: as many shards as CPUs
    pin = ["--shards", str(os.cpu_count() or 1)] if streams else []
    rc, out = _run_cli(cli, *args, *pin, str(cli_input), "b.q")
    assert rc == 0 and "Streaming encode:" not in out
    assert (tmp_path / "a.q").read_bytes() == (tmp_path / "b.q").read_bytes()


def test_cli_hosts_matches_qvz_tpu(cli_input, tmp_path):
    """--hosts 2 encodes across two worker processes, byte-equal to
    qvz_tpu's --hosts 2 and to the port's one-process encode; -x --hosts
    2 decodes it across two worker processes to the host decoder's
    bytes."""
    from qvz_tpu import cli as jx_cli
    flags = ["-f", "0.5", "--shards", "30", "--debug-seed", "-s"]
    rc, out = _run_cli(cli, *flags, "--hosts", "2", "--device", "cpu",
                       str(cli_input), str(tmp_path / "p.q"))
    assert rc == 0, out
    _, jout = _run_cli(jx_cli, *flags, "--hosts", "2", str(cli_input),
                       str(tmp_path / "j.q"))
    _, one = _run_cli(cli, *flags, "--device", "cpu", str(cli_input),
                      str(tmp_path / "one.q"))
    comp = (tmp_path / "p.q").read_bytes()
    assert comp == (tmp_path / "j.q").read_bytes()
    assert comp == (tmp_path / "one.q").read_bytes()
    assert _s_line(out)[::2] == _s_line(jout)[::2] == _s_line(one)[::2]
    rc, out = _run_cli(cli, "-x", "-v", "--hosts", "2", str(tmp_path / "p.q"),
                       str(tmp_path / "p.dec"))
    assert rc == 0 and "on 2 hosts" in out, out
    assert (tmp_path / "p.dec").read_bytes() \
        == host_decode.decode(comp).tobytes()


def test_cli_reuse_books_matches_qvz_tpu(cli_input, golden_dir, tmp_path):
    """--reuse-books takes the codebooks of another container (here one
    designed from another input) and gives qvz_tpu's container for the
    same books."""
    from qvz_tpu import cli as jx_cli
    other = tmp_path / "other.in"
    other.write_bytes(np.concatenate(
        [_data(1000, 16, seed=22) + 33, np.full((1000, 1), 10, np.uint8)],
        1).tobytes())
    for books_flags in (["--shards", "30"], ["--shards", "1"]):
        assert _run_cli(cli, "-c", "2", "--debug-seed", "--device", "cpu",
                        *books_flags, str(other),
                        str(tmp_path / "books.q"))[0] == 0
        flags = ["-c", "2", "--shards", "30", "--debug-seed", "-s",
                 "--reuse-books", str(tmp_path / "books.q")]
        rc, out = _run_cli(cli, *flags, "--device", "cpu", "--profile",
                           str(tmp_path / "prof"), str(cli_input),
                           str(tmp_path / "p.q"))
        assert rc == 0, out
        jrc, jout = _run_cli(jx_cli, *flags, "--no-jax", str(cli_input),
                             str(tmp_path / "j.q"))
        assert jrc == 0, jout
        assert (tmp_path / "p.q").read_bytes() \
            == (tmp_path / "j.q").read_bytes()
        assert _s_line(out) == _s_line(jout)
        # the other input's books open the blocks (after the QVZ2
        # header's 24 bytes; the v1 header has 9)
        books = (tmp_path / "books.q").read_bytes()
        skip = 9 if books_flags[1] == "1" else 24
        assert (tmp_path / "p.q").read_bytes()[24:88] == books[skip:skip + 64]
        phases = json.loads((tmp_path / "prof" / "phases.json").read_text())
        assert phases["phase_seconds"]["stats"] == 0.0
    rc, out = _run_cli(cli, "-c", "3", "--device", "cpu", "--reuse-books",
                       str(tmp_path / "books.q"), str(cli_input),
                       str(tmp_path / "x.q"))
    assert rc == 1 and "cluster count mismatch" in out


def test_cli_profile_writes_qvz_tpus_keys(cli_input, tmp_path):
    """--profile D writes D/phases.json with qvz_tpu's keys."""
    from qvz_tpu import cli as jx_cli
    for mod, d, extra in ((cli, "p", ["--device", "cpu"]),
                          (jx_cli, "j", ["--no-jax"])):
        rc, out = _run_cli(mod, "--shards", "30", "--debug-seed",
                           "--profile", str(tmp_path / d), *extra,
                           str(cli_input), str(tmp_path / f"{d}.q"))
        assert rc == 0, out
    got = json.loads((tmp_path / "p" / "phases.json").read_text())
    want = json.loads((tmp_path / "j" / "phases.json").read_text())
    assert set(got) == set(want)
    for key in ("lines", "columns", "rate", "payload_bytes"):
        assert got[key] == want[key], key
    assert set(got["phase_seconds"]) >= {"cluster", "stats", "design",
                                         "quantize"}
    assert set(got["device_seconds"]) <= set(got["phase_seconds"])


def test_api_compress_hosts(cli_input, tmp_path):
    """api.compress(hosts=2) runs the multi-host driver on `device`: the
    one-process container for the same shard count."""
    from qvz_tpu_torch import api
    st = api.compress(str(cli_input), str(tmp_path / "h.q"), hosts=2,
                      shards=30, clusters=2, debug_seed=True, device="cpu")
    assert st["hosts"] == 2 and st["worker_launches"] == {"hist": [0, 0]}
    one = api.compress(str(cli_input), str(tmp_path / "one.q"), shards=30,
                       clusters=2, debug_seed=True, device="cpu")
    assert (tmp_path / "h.q").read_bytes() \
        == (tmp_path / "one.q").read_bytes()
    assert st["payload_bytes"] == one.payload_bytes


def test_cli_v1_round_trip(golden_dir, tmp_path):
    """--shards 1 writes the C reference's v1 container (tiny_f05), and -x
    decodes it to the golden reconstruction."""
    src = golden_dir / "tiny.in"
    q, u, x = tmp_path / "out.q", tmp_path / "recon.u", tmp_path / "dec"
    assert cli.main(["qvz_tpu_torch", "-f", "0.5", "--shards", "1",
                     "--debug-seed", "--device", "cpu", "-u", str(u),
                     str(src), str(q)]) == 0
    assert q.read_bytes() == (golden_dir / "tiny_f05.q").read_bytes()
    assert u.read_bytes() == (golden_dir / "tiny_f05.u").read_bytes()
    assert cli.main(["qvz_tpu_torch", "-x", "--device", "cpu", str(q),
                     str(x)]) == 0
    assert x.read_bytes() == u.read_bytes()
