"""qvz_tpu_torch conditional statistics (K3's plain version) against
qvz_tpu: the Pallas kernel pallas_kernels._hist_kernel in interpret mode,
the XLA scan of qvz_tpu.ops.stats.conditional_counts and the host C++
counts rt.stats_host. Counts are integers, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qvz_tpu.native import runtime as rt
from qvz_tpu.ops import stats as jx_stats
from qvz_tpu.ops.pallas_kernels import cond_hist_fused, pad_rows
from qvz_tpu_torch.ops import stats as tstats


def _case(n, cols, n_cl, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    clusters = rng.integers(0, n_cl, size=n).astype(np.uint8)
    return data, clusters


def _port(data, clusters, n_cl):
    c0, cond = tstats.conditional_counts_t(
        torch.from_numpy(np.ascontiguousarray(data.T)),
        torch.from_numpy(clusters), n_cl)
    assert c0.dtype == cond.dtype == torch.int64
    return c0.numpy(), cond.numpy()


# (n, cols, clusters): one cluster, three, and twelve (past the clusters
# one block of K3 holds in shared memory); ragged N (not a multiple of
# the Pallas kernel's 512-row block) throughout, and one column.
GEOMS = [(1100, 50, 1), (1333, 20, 3), (777, 9, 12), (600, 1, 3)]


@pytest.mark.parametrize("geom", GEOMS,
                         ids=[f"{n}x{c}c{k}" for n, c, k in GEOMS])
def test_conditional_counts_match_qvz_tpu(geom):
    n, cols, n_cl = geom
    data, clusters = _case(n, cols, n_cl, seed=n + cols)
    c0, cond = _port(data, clusters, n_cl)
    assert c0.shape == (n_cl, 72) and cond.shape == (n_cl, cols - 1, 72, 72)
    h0, hc = rt.stats_host(data, clusters, n_cl)
    assert np.array_equal(c0, h0) and np.array_equal(cond, hc)
    j0, jc = jx_stats.conditional_counts(data, clusters, n_cl)
    assert np.array_equal(c0, j0) and np.array_equal(cond, jc)
    assert c0.sum() == n and cond.sum() == n * (cols - 1)


@pytest.mark.parametrize("geom", GEOMS[:3],
                         ids=[f"{n}x{c}c{k}" for n, c, k in GEOMS[:3]])
def test_conditional_counts_match_hist_kernel(geom):
    """The Pallas _hist_kernel (interpret mode) returns cond as
    (cols-1, C*72, 72) int32 over the valid rows of the padded input."""
    n, cols, n_cl = geom
    data, clusters = _case(n, cols, n_cl, seed=n + cols)
    dp = pad_rows(data)
    clp = np.pad(clusters, (0, dp.shape[0] - n))
    want = np.asarray(cond_hist_fused(jnp.asarray(dp), jnp.asarray(clp),
                                      jnp.int32(n), n_cl, interpret=True))
    _, cond = _port(data, clusters, n_cl)
    got = cond.transpose(1, 0, 2, 3).reshape(cols - 1, n_cl * 72, 72)
    assert np.array_equal(got, want)


def test_conditional_counts_without_clusters_and_from_rows():
    """clusters=None is one cluster; conditional_counts takes (N, cols)."""
    data, _ = _case(900, 7, 1, seed=2)
    a = tstats.conditional_counts(torch.from_numpy(data), None, 1)
    b = _port(data, np.zeros(900, np.uint8), 1)
    for x, y in zip(a, b):
        assert np.array_equal(x.numpy(), y)


def test_conditional_counts_rejects_bad_inputs():
    data, clusters = _case(100, 4, 2, seed=1)
    d = torch.from_numpy(np.ascontiguousarray(data.T))
    with pytest.raises(TypeError):
        tstats.conditional_counts_t(d.int(), None, 1)
    with pytest.raises(ValueError):
        tstats.conditional_counts_t(d, torch.from_numpy(clusters[:50]), 2)
    with pytest.raises(ValueError):
        tstats.conditional_counts_t(d, torch.from_numpy(clusters).int(), 2)
    with pytest.raises(ValueError):
        tstats.conditional_counts_t(d, None, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cl", [1, 3, 12])
def test_hist_kernel_matches_reference(n_cl):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    data, clusters = _case(5000, 30, n_cl, seed=n_cl)
    want = _port(data, clusters, n_cl)
    got = tstats.conditional_counts_t(
        torch.from_numpy(np.ascontiguousarray(data.T)).cuda(),
        torch.from_numpy(clusters).cuda(), n_cl)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert np.array_equal(a, b.cpu().numpy())
