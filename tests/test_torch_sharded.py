"""qvz_tpu_torch's multi-device encode on CPU blocks against qvz_tpu's
8-device virtual CPU mesh (tests/conftest.py) and the port's one-device
results: the statistics, the k-means step and clustering, the
quantization, and whole encodes byte for byte, on an even split of 1,000
reads and a ragged one of 997."""

import jax
import numpy as np
import pytest
import torch

from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu.native import runtime as jrt
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState as JWell
from qvz_tpu.parallel import mesh as jmesh
from qvz_tpu.parallel import sharded as jsharded
from qvz_tpu.pipeline import encode as host_encode
from qvz_tpu.spec import stats as np_stats
from qvz_tpu.spec.kmeans import seed_centroids
from qvz_tpu.spec.pipeline import load_quality_file
from qvz_tpu_torch.native import runtime as trt
from qvz_tpu_torch.ops import kmeans as tkm
from qvz_tpu_torch.ops import quantize as tq
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.parallel import sharded
from qvz_tpu_torch.parallel.mesh import make_mesh
from qvz_tpu_torch.pipeline import encode as port
from qvz_tpu_torch.pipeline import host as port_host

DIST = make_matrix(DISTORTION_MSE)


@pytest.fixture(scope="module")
def small(golden_dir):
    return load_quality_file(golden_dir / "small.in")


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh(devices=["cpu"] * 8)


@pytest.mark.parametrize("n", [1000, 997], ids=["even", "ragged"])
def test_sharded_stats_match(mesh8, tmesh8, small, n):
    data = small[:n]
    clusters = np.random.default_rng(7).integers(0, 3, size=n).astype(
        np.uint8)
    c0_ref, cc_ref = np_stats.conditional_counts(data, clusters, 3)
    jc0, jcc = jsharded.sharded_conditional_counts(mesh8, data, clusters, 3)
    c0, cc = sharded.sharded_conditional_counts(tmesh8, data, clusters, 3)
    for got, want in ((c0, c0_ref), (cc, cc_ref), (c0, jc0), (cc, jcc)):
        np.testing.assert_array_equal(got, want)
    c0, cc = sharded.sharded_conditional_counts(tmesh8, data, None, 1)
    jc0, jcc = jsharded.sharded_conditional_counts(mesh8, data, None, 1)
    np.testing.assert_array_equal(c0, jc0)
    np.testing.assert_array_equal(cc, jcc)


@pytest.mark.parametrize("n", [1000, 997], ids=["even", "ragged"])
def test_sharded_kmeans_step_matches(mesh8, tmesh8, small, n):
    """One Lloyd step (a threshold no movement exceeds) over 8 blocks:
    the assignment and the integer-division means of qvz_tpu's sharded
    step and of the port's one-device step."""
    import jax.numpy as jnp

    data = small[:n]
    means = seed_centroids(data, 3)
    dpad, valid = jsharded.pad_reads(data, 8)
    j_assign, j_means, _ = jsharded.make_sharded_kmeans_step(mesh8, 3)(
        jnp.asarray(dpad.T, dtype=jnp.int32),
        jnp.asarray(means, dtype=jnp.int32), jnp.asarray(valid))
    blocks = sharded.upload(tmesh8.devices, data,
                            sharded.even_bounds(n, 8))
    assigns, new_means, iters = tkm.lloyd(
        data, 3, 1e18, [b.data_t for b in blocks])
    assert iters == 1 and len(assigns) == 8
    assign = torch.cat(assigns).numpy()
    np.testing.assert_array_equal(assign, np.asarray(j_assign)[:n])
    np.testing.assert_array_equal(new_means, np.asarray(j_means))
    one, sums, counts = tkm.kmeans_step(
        torch.from_numpy(np.ascontiguousarray(data.T)),
        torch.from_numpy(means.astype(np.int64)))
    np.testing.assert_array_equal(assign, one.numpy())
    np.testing.assert_array_equal(
        new_means, (sums // counts.clamp(min=1)[:, None]).numpy())


@pytest.mark.parametrize("k", [2, 3])
def test_kmeans_cluster_sharded_matches(mesh8, tmesh8, small, k):
    data = small[:997]
    got = sharded.kmeans_cluster_sharded(tmesh8, data, k, 4.0)
    want = jsharded.kmeans_cluster_sharded(mesh8, data, k, 4.0)
    one = tkm.kmeans_cluster(data, k, 4.0, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], one[0].numpy())
    np.testing.assert_array_equal(got[1], one[1])
    assert got[2] == one[2] > 0
    ids, means, iters = sharded.kmeans_cluster_sharded(tmesh8, data, 1, 4.0)
    assert not ids.any() and iters == 0


@pytest.mark.parametrize("k", [1, 3])
def test_sharded_quantize_matches(mesh8, tmesh8, small, k):
    data = small[:997]
    n, cols = data.shape
    clusters = (np.arange(n) % k).astype(np.uint8)
    c0, cond = np_stats.conditional_counts(data, clusters, k)
    tables = jrt.Design(c0, cond, MODE_RATIO, 0.5, DIST).tables()
    ttables = trt.Design(c0, cond, MODE_RATIO, 0.5, DIST).tables()
    draws = jrt.well_draws7(JWell.debug().state, n * cols).reshape(n, cols)
    m_ref, s_ref, r_ref = jrt.quantize(tables, data, clusters, draws)
    ids = clusters if k > 1 else None
    got = sharded.quantize_sharded_t(tmesh8, ttables, data, ids, draws)
    want = jsharded.quantize_sharded_t(mesh8, tables, data, ids, draws)
    for g, w, ref in zip(got, want, (m_ref, s_ref, r_ref)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ref.T)
    one = tq.quantize_t_device(
        tq.tables_to_torch(ttables, "cpu"),
        torch.from_numpy(np.ascontiguousarray(data.T)),
        torch.from_numpy(np.ascontiguousarray(draws.T)),
        torch.from_numpy(clusters) if k > 1 else None)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g, o.numpy())


def _data(n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-2, 3, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.fixture
def small_warmup(monkeypatch):
    """Prime with a 128-line warmup shard in both packages."""
    monkeypatch.setattr(host_encode, "PRIME_WARMUP_LINES", 128)
    monkeypatch.setattr(port_host, "PRIME_WARMUP_LINES", 128)


@pytest.mark.parametrize("prime", [True, False], ids=["prime", "noprime"])
@pytest.mark.parametrize("n_clusters", [1, 2, 3])
@pytest.mark.parametrize("shards", [4, 13])
def test_mesh_encode_byte_equal(mesh8, tmesh8, small_warmup, shards,
                                n_clusters, prime):
    """encode(mesh=) over 8 CPU blocks (some without lanes at 4 shards)
    equals qvz_tpu's encode(mesh=mesh8) and the port's one-device encode,
    with the -s figures at their printed precision."""
    data = _data(601, 4, seed=shards * 10 + n_clusters)
    kw = dict(n_clusters=n_clusters, ratio=0.5, want_recon=False,
              shards=shards, prime=prime)
    want = host_encode.encode(data, DIST, well_state=JWell.debug(),
                              mesh=mesh8, **kw)
    got = port.encode(data, DIST, well_state=WellState.debug(), mesh=tmesh8,
                      **kw)
    one = port.encode(data, DIST, well_state=WellState.debug(),
                      device="cpu", **kw)
    assert got.compressed == want.compressed
    assert got.compressed == one.compressed
    assert sorted(got.stats.phase_seconds) == sorted(one.stats.phase_seconds)
    line = "{0.rate:.4f} {0.distortion:.4f} {0.payload_bytes}"
    assert line.format(got.stats) == line.format(want.stats) \
        == line.format(one.stats)
    np.testing.assert_array_equal(got.clusters, one.clusters)


@pytest.mark.parametrize("shards", [1, 13])
def test_mesh_encode_recon_and_v1(small_warmup, tmesh8, shards):
    """With -u the blocks' reconstructions concatenate to the one-device
    one; at shards == 1 the statistics and k-means run on the blocks and
    the host engine codes the v1 container."""
    data = _data(997, 4, seed=3)
    kw = dict(n_clusters=3, ratio=0.5, want_recon=True, shards=shards)
    got = port.encode(data, DIST, well_state=WellState.debug(),
                      mesh=make_mesh(devices=["cpu"] * 3), **kw)
    one = port.encode(data, DIST, well_state=WellState.debug(),
                      device="cpu", **kw)
    assert got.compressed == one.compressed
    np.testing.assert_array_equal(got.reconstructed, one.reconstructed)
    assert got.stats.distortion == one.stats.distortion
    if shards == 1:
        ref = port_host.encode(data, DIST, well_state=WellState.debug(),
                               **kw)
        assert got.compressed == ref.compressed


def test_block_bounds():
    """Blocks cut at shard boundaries: block 0 holds the warmup shard, the
    lanes split into groups that differ by at most one, no block is
    empty; the even split of the v1 path likewise."""
    counts = [100, 40, 40, 40, 40, 40, 37]
    offs = np.cumsum([0] + counts)
    assert sharded.lane_bounds(offs, 1, 3) == [(0, 180), (180, 260),
                                               (260, 337)]
    assert sharded.lane_bounds(offs, 0, 3) == [(0, 140), (140, 220),
                                               (220, 337)]
    assert sharded.lane_bounds(offs, 1, 8) == [
        (0, 100), (100, 140), (140, 180), (180, 220), (220, 260),
        (260, 300), (300, 337)]
    assert sharded.lane_bounds(offs, 1, 1) == [(0, 337)]
    assert sharded.even_bounds(997, 8)[-1] == (872, 997)
    assert sharded.even_bounds(3, 8) == [(0, 1), (1, 2), (2, 3)]


def test_make_mesh():
    m = make_mesh(devices=["cpu", torch.device("cpu")])
    assert m.size == 2 and m.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    with pytest.raises(ValueError):
        make_mesh(devices=["meta"])
    if not torch.cuda.is_available():
        for bad in (lambda: make_mesh(1), lambda: make_mesh(),
                    lambda: make_mesh(devices=["cuda:0"])):
            with pytest.raises(RuntimeError):
                bad()
    else:
        with pytest.raises(RuntimeError, match="visible"):
            make_mesh(torch.cuda.device_count() + 1)
