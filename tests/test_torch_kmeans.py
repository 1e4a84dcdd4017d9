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
# tile of K4; K = 150 (phase 16's cluster count, K4's shared-memory sums);
# N not a multiple of K4's 512-read tile nor of 4 (its byte-wise staging)
STEP_GEOMS = [(700, 36, 3), (1500, 100, 5), (512, 17, 2), (100, 12, 2),
              (650, 20, 11), (700, 20, 150), (1037, 100, 3)]


@pytest.mark.parametrize("geom", STEP_GEOMS,
                         ids=[f"{n}x{c}k{k}" for n, c, k in STEP_GEOMS])
def test_kmeans_step_matches_pallas_and_oracle(geom):
    n, cols, K = geom
    rng = np.random.default_rng(n)
    data = rng.integers(0, 72, size=(n, cols)).astype(np.uint8)
    means = rng.integers(0, 72, size=(K, cols)).astype(np.int32)
    got = _port_step(data, means)
    for name, a, b in zip(("assign", "sums", "counts"), got,
                          oracle_step(data, means, K)):
        assert np.array_equal(a, b), name
    if K <= 128:
        for name, a, c in zip(("assign", "sums", "counts"), got,
                              _pallas_step(data, means, K)):
            assert np.array_equal(a, c), name
    else:
        # the Pallas kernel holds at most 128 means (its lane width);
        # above that qvz_tpu's XLA step: the assignment and the new means
        assign, new_means, _ = jx_kmeans._kmeans_step(
            jnp.asarray(data), jnp.asarray(means), K)
        assert np.array_equal(got[0], np.asarray(assign))
        assert np.array_equal(got[1] // np.maximum(got[2], 1)[:, None],
                              np.asarray(new_means))


# An H100's limits: shared memory a block may ask for and an SM holds, SMs
H100 = (232_448, 233_472, 132)


@pytest.mark.parametrize("geom,want", [
    ((1_000_000, 100, 3), dict(kt=4, k_pad=4, mode=0, means_shared=True,
                               T=512, blocks_per_sm=2, grid=264)),
    ((200_000, 20, 150), dict(kt=8, k_pad=152, mode=1, means_shared=True,
                              T=512, grid=391)),
    ((4_100, 20, 150), dict(mode=1, T=16, grid=257)),
    ((1_000_000, 1022, 3), dict(kt=4, k_pad=4, mode=1, means_shared=True)),
    ((1_000_000, 1022, 255), dict(kt=8, k_pad=256, mode=2,
                                  means_shared=False)),
], ids=["1Mx100k3", "200kx20k150", "4100x20k150", "1Mx1022k3",
        "1Mx1022k255"])
def test_step_shape(geom, want):
    """K4's tile and layout: registers for the main path's K = 3, shared
    sums at K = 150, and the 1,022-column ceiling still fits the card;
    the largest tile that gives every SM two tiles, the smallest where
    none does (a small N)."""
    n, cols, k = geom
    got = tkm.step_shape(n, cols, k, *H100)
    assert {key: got[key] for key in want} == want
    assert got["smem"] == tkm.layout_bytes(
        got["T"], cols, k, got["k_pad"], got["kt"], got["mode"],
        got["means_shared"]) <= H100[0]
    assert got["T"] % 16 == 0 and got["T"] <= tkm.THREADS * tkm.READS
    # two tiles of cols rows (padded to 4) in the layout
    assert got["smem"] >= 2 * -(-cols // 4) * 4 * (got["T"] + tkm.ROW_PAD)
    assert got["tiles"] == -(-n // got["T"])
    assert got["grid"] <= got["tiles"]
    assert -(-got["tiles"] // got["grid"]) * got["T"] \
        <= tkm.MAX_READS_PER_BLOCK
    if got["blocks_per_sm"] >= 2:
        assert 2 * (got["smem"] + tkm.SMEM_RESERVED) <= H100[1]
    if got["tiles"] >= 2 * H100[2] and got["T"] < tkm.TILES[0]:
        # the next larger tile would leave an SM fewer than two tiles,
        # or fit fewer than two blocks an SM
        big = 2 * got["T"]
        b = tkm.layout_bytes(big, cols, k, got["k_pad"], got["kt"],
                             got["mode"], got["means_shared"])
        assert -(-n // big) < 2 * H100[2] or b > H100[0] \
            or H100[1] // (b + tkm.SMEM_RESERVED) < 2


def test_step_shape_caps_reads_per_block():
    """A block's u32 accumulators hold at most 2^23 reads: a larger N
    gets more blocks than the card holds at once."""
    got = tkm.step_shape(2 ** 34, 4, 3, *H100)
    assert -(-got["tiles"] // got["grid"]) * got["T"] \
        <= tkm.MAX_READS_PER_BLOCK
    assert got["grid"] > got["blocks_per_sm"] * H100[2]


@pytest.mark.parametrize("k,cols", [(3, 100), (150, 20), (5, 7)])
def test_pack_means_layout_and_distances(k, cols):
    """pack_means: word (g, j) holds columns 4g..4g+3 of mean j, lowest
    byte first, padding 0; the kernel's form of the distance (per 4
    columns, sum of squared byte differences of a read's word and a mean's
    word) equals the direct squared distance, padding included."""
    rng = np.random.default_rng(k)
    means = rng.integers(0, 256, size=(k, cols))
    kt = 4 if k <= 4 else 8
    k_pad = -(-k // kt) * kt
    w = tkm.pack_means(torch.from_numpy(means), k_pad).numpy()
    cols4 = -(-cols // 4) * 4
    assert w.shape == (cols4 // 4, k_pad) and w.dtype == np.int32
    b = w.view(np.uint32)[..., None] >> (8 * np.arange(4)) & 0xff
    unpacked = b.transpose(1, 0, 2).reshape(k_pad, cols4)
    assert np.array_equal(unpacked[:k, :cols], means)
    assert not unpacked[k:].any() and not unpacked[:, cols:].any()
    reads = rng.integers(0, 256, size=(50, cols))
    padded = np.zeros((50, cols4), np.int64)
    padded[:, :cols] = reads
    xb = padded.reshape(50, cols4 // 4, 4)
    mb = unpacked.reshape(k_pad, cols4 // 4, 4)
    dist = ((xb[:, None] - mb[None]) ** 2).sum((2, 3))[:, :k]
    direct = ((reads[:, None, :] - means[None]) ** 2).sum(-1)
    assert np.array_equal(dist, direct)


def test_launch_takes_only_card_tensors():
    """K4's bare launch has no CPU path: a CPU tensor raises before any
    library is loaded."""
    d = torch.zeros((8, 64), dtype=torch.uint8)
    m4 = tkm.pack_means(torch.zeros((3, 8), dtype=torch.long), 4)
    shape = tkm.step_shape(64, 8, 3, *H100)
    with pytest.raises(ValueError):
        tkm.launch(d, m4, 3, shape)


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


def test_kmeans_cluster_one_copy_back_a_step(monkeypatch):
    """Each Lloyd step copies one packed (K, cols + 1) buffer to the host:
    the sums, and the counts in the last column."""
    data = _reads(900, 24, seed=900)
    fetched = []
    to_host = tkm._to_host

    def spy(t):
        out = to_host(t)
        fetched.append(out)
        return out

    monkeypatch.setattr(tkm, "_to_host", spy)
    assign, means, iters = tkm.kmeans_cluster(data, 4, 0.0, device="cpu")
    assert len(fetched) == iters > 1
    assert all(f.shape == (4, 25) and f.dtype == np.int64 for f in fetched)
    last = fetched[-1]
    assert last[:, 24].sum() == 900
    a = assign.numpy()
    assert np.array_equal(last[:, 24], np.bincount(a, minlength=4))
    sums = np.zeros((4, 24), np.int64)
    np.add.at(sums, a, data.astype(np.int64))
    assert np.array_equal(last[:, :24], sums)


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
@pytest.mark.parametrize("geom", [(200_000, 20, 150), (1037, 100, 3),
                                  (999, 1022, 9), (700, 1022, 255)],
                         ids=["200kx20k150", "1037x100k3", "999x1022k9",
                              "700x1022k255"])
def test_kmeans_kernel_layouts(geom):
    """K4 in its shared-sums layout (K = 150), at N not a multiple of 4,
    at the column ceiling, and there with 255 means (sums in device
    memory, the means unshared), against the plain step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 has no CPU mode)")
    n, cols, K = geom
    data = _reads(n, cols, seed=K)
    means = data[np.linspace(0, n - 1, K).astype(int)].astype(np.int32)
    want = _port_step(data, means)
    got = tkm.kmeans_step(
        torch.from_numpy(np.ascontiguousarray(data.T)).cuda(),
        torch.from_numpy(means).cuda())
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert np.array_equal(a, b.cpu().numpy())


@pytest.mark.cuda
def test_kmeans_cluster_on_card_matches_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 has no CPU mode)")
    data = _reads(20_000, 20, seed=5)
    for K in (3, 150):
        assign, means, iters = tkm.kmeans_cluster(data, K, 4.0)
        h = rt.kmeans_host(data, K, 4.0)
        assert np.array_equal(assign.cpu().numpy(), h[0])
        assert np.array_equal(means, h[1]) and iters == h[2]


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
