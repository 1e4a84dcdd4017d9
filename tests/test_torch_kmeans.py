"""qvz_tpu_torch k-means (K4's plain step and the convergence loop)
against qvz_tpu: the Pallas kernel pallas_kernels._kmeans_kernel in
interpret mode, a numpy oracle, qvz_tpu.ops.kmeans.kmeans_cluster (the
XLA step on the CPU) and the host C++ rt.kmeans_host. Assignments, sums,
counts, means and iteration counts are integers: every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qvz_tpu.native import runtime as rt
from qvz_tpu.ops import kmeans as jx_kmeans
from qvz_tpu.ops.pallas_kernels import kmeans_step_fused, pad_rows
from qvz_tpu_torch.ops import kmeans as tkm


def oracle_step(data, means, K):
    d = data.astype(np.int64)
    m = means.astype(np.int64)
    dist = ((d[:, None, :] - m[None]) ** 2).sum(-1)
    assign = dist.argmin(1)
    sums = np.zeros((K, data.shape[1]), dtype=np.int64)
    np.add.at(sums, assign, d)
    counts = np.bincount(assign, minlength=K)
    return assign, sums, counts


def _port_step(data, means):
    a, s, c = tkm.kmeans_step(torch.from_numpy(np.ascontiguousarray(data.T)),
                              torch.from_numpy(means))
    assert a.dtype == torch.int32
    assert s.dtype == c.dtype == torch.int64
    return a.numpy(), s.numpy(), c.numpy()


def _pallas_step(data, means, K):
    n = data.shape[0]
    a, s, c = kmeans_step_fused(jnp.asarray(pad_rows(data)),
                                jnp.asarray(means), jnp.int32(n), K,
                                interpret=True)
    return np.asarray(a)[:n], np.asarray(s), np.asarray(c)


# (n, cols, K): the geometries of test_pallas.py, among them N not a
# multiple of the Pallas kernel's 512-row block, and K past one 8-cluster
# tile of K4
STEP_GEOMS = [(700, 36, 3), (1500, 100, 5), (512, 17, 2), (100, 12, 2),
              (650, 20, 11)]


@pytest.mark.parametrize("geom", STEP_GEOMS,
                         ids=[f"{n}x{c}k{k}" for n, c, k in STEP_GEOMS])
def test_kmeans_step_matches_pallas_and_oracle(geom):
    n, cols, K = geom
    rng = np.random.default_rng(n)
    data = rng.integers(0, 72, size=(n, cols)).astype(np.uint8)
    means = rng.integers(0, 72, size=(K, cols)).astype(np.int32)
    got = _port_step(data, means)
    for name, a, b, c in zip(("assign", "sums", "counts"), got,
                             oracle_step(data, means, K),
                             _pallas_step(data, means, K)):
        assert np.array_equal(a, b), name
        assert np.array_equal(a, c), name


def test_kmeans_step_ties_break_low():
    """Two identical means: every read takes the lower index."""
    data = np.full((600, 8), 30, dtype=np.uint8)
    means = np.full((3, 8), 10, dtype=np.int32)
    means[2] = 60
    a, s, c = _port_step(data, means)
    assert np.all(a == 0)
    assert c.tolist() == [600, 0, 0]
    assert np.array_equal(a, _pallas_step(data, means, 3)[0])
    # ties between rows 1 and 2 only: the lower of the two wins
    means[0] = 70
    means[2] = means[1]
    a, _, c = _port_step(data, means)
    assert np.all(a == 1) and c.tolist() == [0, 600, 0]


def test_kmeans_step_rejects_bad_inputs():
    d = torch.zeros((4, 10), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tkm.kmeans_step(d.int(), torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        tkm.kmeans_step(d, torch.zeros((2, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        tkm.kmeans_step(d, torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        tkm.kmeans_step(d, torch.full((2, 4), 256, dtype=torch.int32))


def _reads(n, cols, seed):
    """Reads of three shapes (flat high, falling, low), so that k-means
    takes several steps to converge."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, size=(n, 1))
    start = np.choose(kind, [[38], [30], [15]]) + rng.integers(-3, 4, (n, 1))
    drift = np.choose(kind, [[0], [-1], [0]]) * (np.arange(cols) // 4)
    steps = rng.integers(-2, 3, size=(n, cols)).cumsum(1)
    return np.clip(start + drift + steps, 0, 71).astype(np.uint8)


# (n, cols, K, threshold)
CLUSTER_CASES = [(1200, 30, 3, 4.0), (900, 24, 4, 0.0), (500, 12, 2, 4.0)]


@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=[f"{n}x{c}k{k}T{t:g}"
                              for n, c, k, t in CLUSTER_CASES])
def test_kmeans_cluster_matches_qvz_tpu(case, capsys):
    n, cols, K, threshold = case
    data = _reads(n, cols, seed=n)
    assign, means, iters = tkm.kmeans_cluster(data, K, threshold,
                                              verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert assign.dtype == torch.uint8 and means.dtype == np.uint8
    assert iters > 1
    j = jx_kmeans.kmeans_cluster(data, K, threshold, verbose=True)
    assert capsys.readouterr().out == out
    h = rt.kmeans_host(data, K, threshold, verbose=True)
    assert capsys.readouterr().out == out
    for want in (j, h):
        assert np.array_equal(assign.numpy(), np.asarray(want[0]))
        assert np.array_equal(means, np.asarray(want[1]))
        assert iters == want[2]
    assert "Total number of iterations" in out


def test_kmeans_cluster_one_cluster():
    data = _reads(50, 6, seed=1)
    assign, means, iters = tkm.kmeans_cluster(data, 1, 4.0, device="cpu")
    assert iters == 0 and not assign.any() and assign.shape == (50,)
    assert np.array_equal(means, data[:1])


def test_kmeans_cluster_uses_the_given_device_copy():
    """data_t, the reads already on the device, is what the steps read."""
    data = _reads(400, 10, seed=4)
    want = tkm.kmeans_cluster(data, 3, 4.0, device="cpu")
    got = tkm.kmeans_cluster(
        data, 3, 4.0, data_t=torch.from_numpy(np.ascontiguousarray(data.T)))
    assert torch.equal(want[0], got[0])
    assert np.array_equal(want[1], got[1]) and want[2] == got[2]


@pytest.mark.cuda
def test_kmeans_kernel_matches_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 has no CPU mode)")
    data = _reads(5000, 40, seed=7)
    for K in (3, 11):
        means = data[:K].astype(np.int32)
        means[1] = means[0]                    # a tie on every read
        want = _port_step(data, means)
        got = tkm.kmeans_step(
            torch.from_numpy(np.ascontiguousarray(data.T)).cuda(),
            torch.from_numpy(means).cuda())
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert np.array_equal(a, b.cpu().numpy())
