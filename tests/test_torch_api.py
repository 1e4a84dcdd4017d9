"""qvz_tpu_torch's public API against qvz_tpu's: the same constants at the
package and in ``api``, and ``api.compress`` passing the keywords that
``compress_bytes`` does not take on to the encode (reuse_blocks, verbose,
mesh), byte-equal to ``qvz_tpu.api.compress``."""

import numpy as np
import pytest

import qvz_tpu
import qvz_tpu.api as japi
import qvz_tpu_torch
import qvz_tpu_torch.api as tapi
from qvz_tpu.pipeline import encode as host_encode
from qvz_tpu_torch.format import container_v2
from qvz_tpu_torch.native import runtime as trt
from qvz_tpu_torch.parallel.mesh import make_mesh
from qvz_tpu_torch.pipeline import host as port_host


def _constants(mod) -> dict:
    return {k: getattr(mod, k) for k in dir(mod) if k.isupper()}


@pytest.mark.parametrize("pair", [(qvz_tpu, qvz_tpu_torch), (japi, tapi)],
                         ids=["package", "api"])
def test_exported_constants_match(pair):
    jmod, tmod = pair
    assert _constants(tmod) == _constants(jmod)
    assert {"MODE_FIXED", "MODE_RATIO", "DISTORTION_MSE",
            "DISTORTION_LORENTZ", "DISTORTION_MANHATTAN",
            "DISTORTION_CUSTOM"} <= set(_constants(tmod))


def test_api_functions_match():
    names = {"compress", "compress_bytes", "decompress", "decompress_bytes"}
    assert names <= {k for k in dir(japi) if callable(getattr(japi, k))}
    assert names <= {k for k in dir(tapi) if callable(getattr(tapi, k))}


@pytest.fixture
def quality_file(tmp_path, monkeypatch):
    monkeypatch.setattr(host_encode, "PRIME_WARMUP_LINES", 256)
    monkeypatch.setattr(port_host, "PRIME_WARMUP_LINES", 256)
    rng = np.random.default_rng(5)
    n, cols = 1200, 7
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0, 71)
    text = np.concatenate([data + 33, np.full((n, 1), 10)], 1)
    path = tmp_path / "in.qual"
    path.write_bytes(text.astype(np.uint8).tobytes())
    return path


def _books(comp: bytes, n_clusters: int) -> bytes:
    """The codebook blocks of a QVZ2 container."""
    head = container_v2.parse(comp, blocks_len=None)
    tables = trt.tables_from_blocks(comp[container_v2.header_size():],
                                    n_clusters, head.columns)
    return comp[container_v2.header_size():][:tables.consumed]


@pytest.mark.parametrize("n_clusters", [1, 3])
def test_compress_forwards_reuse_blocks_and_verbose(quality_file, tmp_path,
                                                    capsys, n_clusters):
    kw = dict(shards=4, debug_seed=True, clusters=n_clusters)
    first = tmp_path / "first.q"
    tapi.compress(str(quality_file), str(first), device="cpu", **kw)
    books = _books(first.read_bytes(), n_clusters)
    want, got = tmp_path / "want.q", tmp_path / "got.q"
    jst = japi.compress(str(quality_file), str(want), use_jax=False,
                        reuse_blocks=books, verbose=True, **kw)
    jout = capsys.readouterr().out
    tst = tapi.compress(str(quality_file), str(got), device="cpu",
                        reuse_blocks=books, verbose=True, **kw)
    tout = capsys.readouterr().out
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes() == first.read_bytes()
    assert tst.phase_seconds["stats"] == 0.0
    assert f"{tst.rate:.4f} {tst.distortion:.4f}" \
        == f"{jst.rate:.4f} {jst.distortion:.4f}"
    assert "Clustering took" in tout and "Clustering took" in jout


def test_compress_forwards_mesh(quality_file, tmp_path):
    want, got = tmp_path / "want.q", tmp_path / "got.q"
    japi.compress(str(quality_file), str(want), use_jax=False, shards=4,
                  debug_seed=True, clusters=2)
    tapi.compress(str(quality_file), str(got), shards=4, debug_seed=True,
                  clusters=2, mesh=make_mesh(devices=["cpu"] * 3))
    assert got.read_bytes() == want.read_bytes()


def test_compress_refuses_jax_and_unknown_keywords(quality_file, tmp_path):
    out = str(tmp_path / "o.q")
    with pytest.raises(TypeError, match="use_jax"):
        tapi.compress(str(quality_file), out, device="cpu", use_jax=True)
    with pytest.raises(TypeError, match="use_jax"):
        tapi.compress_bytes(quality_file.read_bytes(), device="cpu",
                            use_jax=False)
    with pytest.raises(TypeError, match="reuse_blocks"):
        tapi.compress(str(quality_file), out, hosts=2, device="cpu",
                      reuse_blocks=b"")
