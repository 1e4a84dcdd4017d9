"""qvz_tpu_torch's bounded-memory streaming encode on the CPU (the kernels'
plain versions) against qvz_tpu's host streaming encode: containers
byte-equal at -c 1 primed and unprimed and at -c 3, the -u file equal,
the checkpoint path equal, the round trip through the port's decode, and
K3 and K1 run on every chunk and every shard."""

import numpy as np
import pytest
import torch

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.format import container_v2
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState as JxWell
from qvz_tpu.pipeline.streaming import encode_streaming as jx_streaming
from qvz_tpu_torch.ops import quantize as tquant
from qvz_tpu_torch.ops import stats as tstats
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline import decode as port_decode
from qvz_tpu_torch.pipeline.streaming import encode_streaming

DIST = make_matrix(DISTORTION_MSE)
CHUNK = 7000      # five chunks of the 30,000 reads
SHARDS = 5


@pytest.fixture(scope="module")
def qfile(tmp_path_factory):
    """The 30,000 x 40 input of tests/test_streaming.py."""
    rng = np.random.default_rng(77)
    n, cols = 30000, 40
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    out = np.empty((n, cols + 1), dtype=np.uint8)
    out[:, :cols] = data + 33
    out[:, cols] = 10
    path = tmp_path_factory.mktemp("tst") / "st.in"
    path.write_bytes(out.tobytes())
    return str(path), data


def _jax(path, out, **kw):
    return jx_streaming(path, str(out), ratio=0.5,
                        well_state=JxWell.debug(), dist_matrix=DIST,
                        shards=SHARDS, chunk_lines=CHUNK, use_jax=False,
                        **kw)


def _port(path, out, **kw):
    return encode_streaming(path, str(out), ratio=0.5,
                            well_state=WellState.debug(), dist_matrix=DIST,
                            shards=SHARDS, chunk_lines=CHUNK, device="cpu",
                            **kw)


@pytest.mark.parametrize("n_clusters,prime", [(1, True), (1, False),
                                              (3, True)],
                         ids=["c1-prime", "c1-noprime", "c3-prime"])
def test_streaming_matches_qvz_tpu(qfile, tmp_path, n_clusters, prime):
    path, _ = qfile
    want = _jax(path, tmp_path / "j.q", n_clusters=n_clusters, prime=prime)
    got = _port(path, tmp_path / "p.q", n_clusters=n_clusters, prime=prime)
    assert (tmp_path / "p.q").read_bytes() == (tmp_path / "j.q").read_bytes()
    assert got["rate"] == want["rate"]
    assert got["payload_bytes"] == want["payload_bytes"]
    assert abs(got["distortion"] - want["distortion"]) < 1e-9
    assert got["shards"] == want["shards"]
    assert got.get("kmeans_iters") == want.get("kmeans_iters")
    assert got["device_peak_bytes"] == 0
    assert set(want) <= set(got)


def test_streaming_recon_u_matches_qvz_tpu(qfile, tmp_path):
    path, _ = qfile
    _jax(path, tmp_path / "j.q", n_clusters=3,
         recon_path=str(tmp_path / "j.u"))
    _port(path, tmp_path / "p.q", n_clusters=3,
          recon_path=str(tmp_path / "p.u"))
    assert (tmp_path / "p.q").read_bytes() == (tmp_path / "j.q").read_bytes()
    assert (tmp_path / "p.u").read_bytes() == (tmp_path / "j.u").read_bytes()


def test_streaming_reuse_books(qfile, tmp_path):
    """The checkpoint path: the blocks of an earlier container skip the
    statistics and the design and give the same container."""
    path, _ = qfile
    _port(path, tmp_path / "a.q")
    comp = (tmp_path / "a.q").read_bytes()
    st = _port(path, tmp_path / "b.q",
               reuse_blocks=comp[container_v2.header_size():])
    assert st["stats_s"] == 0.0
    assert (tmp_path / "b.q").read_bytes() == comp


def test_streaming_round_trip(qfile, tmp_path):
    """The port's decode (K5's plain version) gives back the -u
    reconstruction. 512 shards, as chip_smoke.py's streamed encode: the
    plain decoder's steps run all lanes at once, so short lanes keep it
    quick."""
    path, data = qfile
    encode_streaming(path, str(tmp_path / "p.q"), ratio=0.5,
                     well_state=WellState.debug(), dist_matrix=DIST,
                     shards=512, chunk_lines=CHUNK, device="cpu",
                     recon_path=str(tmp_path / "p.u"))
    dec = port_decode.decode((tmp_path / "p.q").read_bytes(), device="cpu")
    assert dec.tobytes() == (tmp_path / "p.u").read_bytes()
    assert dec.shape == (data.shape[0], data.shape[1] + 1)


def test_streaming_runs_k3_and_k1_on_each_chunk_and_shard(qfile, tmp_path,
                                                          monkeypatch):
    """K3's plain version counts each chunk and K1's quantizes each shard,
    the warmup shard included: the wrappers take the plain versions on
    CPU tensors, so the calls are counted there."""
    path, data = qfile
    calls = {"hist": [], "quantize": []}

    def counted(name, fn, arg):
        def wrapper(*args, **kw):
            calls[name].append(args[arg].shape[1])  # the (cols, N) reads
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(tstats, "conditional_counts_reference",
                        counted("hist", tstats.conditional_counts_reference,
                                0))
    monkeypatch.setattr(tquant, "quantize_reference",
                        counted("quantize", tquant.quantize_reference, 1))
    st = _port(path, tmp_path / "p.q", n_clusters=3)
    n = data.shape[0]
    assert calls["hist"] == [CHUNK] * (n // CHUNK) + [n % CHUNK]
    assert len(calls["quantize"]) == st["shards"] == SHARDS + 1
    assert sum(calls["quantize"]) == n


def test_streaming_on_cuda_without_a_card_raises(qfile, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    path, _ = qfile
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_streaming(path, str(tmp_path / "x.q"))
    assert not (tmp_path / "x.q").exists()
