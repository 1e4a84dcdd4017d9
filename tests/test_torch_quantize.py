"""qvz_tpu_torch quantize (K1's plain version) against qvz_tpu's device
quantize: the XLA gather scan and the two Pallas kernels
(quantize_pallas._qkernel_merged and _qkernel, in interpret mode).
Outputs are integers, so every comparison is element-exact."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops import quantize as jx_quant
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.spec import stats as np_stats
from qvz_tpu_torch.native import runtime as prt
from qvz_tpu_torch.ops import quantize as tq


class Tables(NamedTuple):
    """One design's tables from each runtime: qvz_tpu's for its side, the
    port's (which also carry K1's folded forms) for the port's."""
    jx: object
    port: object


def _case(n, cols, n_cl, ratio, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, max(cols - 1, 0)))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    clusters = (np.arange(n) % n_cl).astype(np.uint8)
    c0, cond = np_stats.conditional_counts(data, clusters, n_cl)
    dist = make_matrix(DISTORTION_MSE)
    tables = Tables(rt.Design(c0, cond, MODE_RATIO, ratio, dist).tables(),
                    prt.Design(c0, cond, MODE_RATIO, ratio, dist).tables())
    draws = rng.integers(0, 128, size=(n, cols)).astype(np.uint8)
    return tables, data, clusters, draws


def _port(tables, data, clusters, draws):
    tabs = tq.tables_to_torch(tables.port, "cpu")
    out = tq.quantize_t_device(
        tabs, torch.from_numpy(np.ascontiguousarray(data.T)),
        torch.from_numpy(np.ascontiguousarray(draws.T)),
        torch.from_numpy(clusters))
    return [o.numpy() for o in out]


# (n, cols, clusters, ratio, seed): the geometries of test_pallas.py —
# the 3000 x 24 two-cluster case, the rate extremes, one column and
# multi-cluster high rate.
GEOMS = [
    (3000, 24, 2, 0.5, 41),
    (1500, 8, 1, 0.0, 8),
    (1500, 8, 1, 0.9, 98),
    (1500, 1, 1, 0.5, 51),
    (1500, 6, 3, 0.85, 91),
    # many clusters, and N not a multiple of K1's reads a thread
    (2000, 10, 20, 0.5, 20),
    (1037, 12, 3, 0.5, 37),
]
# QVZ_TPU_QUANTIZE_PALLAS / QVZ_TPU_QUANT_MERGED: the XLA gather scan,
# the merged Pallas kernel (#1) and the split Pallas kernel (#2)
SETTINGS = [("0", "1"), ("interpret", "1"), ("interpret", "0")]


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=["xla", "merged", "split"])
@pytest.mark.parametrize("geom", GEOMS,
                         ids=[f"{g[0]}x{g[1]}c{g[2]}r{g[3]}" for g in GEOMS])
def test_quantize_reference_matches_jax(monkeypatch, geom, setting):
    tables, data, clusters, draws = _case(*geom)
    monkeypatch.setenv("QVZ_TPU_QUANTIZE_PALLAS", setting[0])
    monkeypatch.setenv("QVZ_TPU_QUANT_MERGED", setting[1])
    want = jx_quant.quantize_t_device(tables.jx, data, clusters, draws)[:3]
    got = _port(tables, data, clusters, draws)
    for name, a, b in zip(("mid", "qs", "qv"), want, got):
        assert b.dtype == np.int32
        assert np.array_equal(np.asarray(a), b), name


def test_quantize_reference_matches_column_windows(monkeypatch):
    """The Pallas kernel with 3-column windows threads prev across
    window boundaries (QVZ_TPU_QUANT_COLW)."""
    tables, data, clusters, draws = _case(3000, 24, 2, 0.5, 44)
    monkeypatch.setenv("QVZ_TPU_QUANTIZE_PALLAS", "interpret")
    monkeypatch.setenv("QVZ_TPU_QUANT_MERGED", "1")
    monkeypatch.setenv("QVZ_TPU_QUANT_COLW", "3")
    want = jx_quant.quantize_t_device(tables.jx, data, clusters, draws)[:3]
    for a, b in zip(want, _port(tables, data, clusters, draws)):
        assert np.array_equal(np.asarray(a), b)


def test_quantize_reference_matches_host_colmajor():
    """One cluster, the WELL draws of the host runtime: the port equals
    rt.quantize_colmajor, which draws its dither itself."""
    from qvz_tpu.ops.well import WellState

    tables, data, _, _ = _case(2000, 16, 1, 0.5, 3)
    ws = WellState.debug()
    words = np.asarray(ws.state, dtype=np.uint32)[
        [(ws.n + i) & 31 for i in range(32)]]
    m_h, qs_h, recon, _ = rt.quantize_colmajor(
        tables.jx, np.ascontiguousarray(data.T), None, words,
        want_recon=True)
    draws = rt.well_draws7(words, data.size).reshape(data.shape)
    tabs = tq.tables_to_torch(tables.port, "cpu")
    mid, qs, qv = tq.quantize_reference(
        tabs, torch.from_numpy(np.ascontiguousarray(data.T)),
        torch.from_numpy(np.ascontiguousarray(draws.T)))
    assert np.array_equal(mid.numpy(), m_h.astype(np.int32))
    assert np.array_equal(qs.numpy(), qs_h.astype(np.int32))
    assert np.array_equal(qv.numpy().T, recon)


def _emulate_kernel(tabs, data, draws, clusters):
    """K1's arithmetic on its folded tables (csrc/quantize.cu): per
    column, e = ctx2[(cl*cols + c)*72 + prev], ctx = e & 0xff, choice =
    draw >= e >> 8, v = qsv[(2*(pair_bounds[cc] + ctx) + choice)*72 + x],
    qs = v & 0xff, qv = v >> 8."""
    cols = data.shape[1]
    ctx2 = tabs["ctx2"].numpy().astype(np.int64)
    qsv = tabs["qsv"].numpy().astype(np.int64)
    bounds = tabs["pair_bounds"].numpy().astype(np.int64)
    prev = np.zeros(len(data), np.int64)
    out = np.zeros((3, cols, len(data)), np.int32)
    for c in range(cols):
        cc = clusters.astype(np.int64) * cols + c
        e = ctx2[cc * 72 + prev]
        p = bounds[cc] + (e & 0xff)
        pc = 2 * p + (draws[:, c] >= e >> 8)
        v = qsv[pc * 72 + data[:, c]]
        out[:, c] = 1 + pc, v & 0xff, v >> 8
        prev = v >> 8
    return out


@pytest.mark.parametrize("geom", [(2000, 10, 20, 0.5, 20),
                                  (1037, 12, 3, 0.5, 37),
                                  (1500, 8, 1, 0.9, 98),
                                  (3000, 20, 150, 0.5, 150)],
                         ids=["2000x10c20", "1037x12c3", "1500x8c1",
                              "3000x20c150"])
def test_folded_tables_give_the_reference(geom):
    """tables_to_torch's ctx2, qsv and pair_bounds, read as K1 reads
    them, give the plain version's mid, qs and qv; each (cluster, column)
    holds at most max_pairs pairs."""
    tables, data, clusters, draws = _case(*geom)
    tabs = tq.tables_to_torch(tables.port, "cpu")
    got = _emulate_kernel(tabs, data, draws, clusters)
    want = _port(tables, data, clusters, draws)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    bounds = tabs["pair_bounds"].numpy()
    assert bounds[-1] == len(tabs["qratio"]) and bounds[0] == 0
    assert np.diff(bounds).max() == tabs["max_pairs"]
    assert tabs["ctx2"].numpy().max() < 1 << 16


def _fold(t):
    """K1's folded forms computed from the plain tables of `t`."""
    ctx = np.maximum(np.asarray(t.ctxmap, np.int64), 0)
    p = np.minimum(np.asarray(t.pair_base, np.int64)[:, None] + ctx,
                   t.n_pairs - 1)
    ctx2 = ctx | np.asarray(t.qratio, np.int64)[p] << 8
    qsv = (np.asarray(t.qs_map, np.int64)
           | np.asarray(t.qv_map, np.int64) << 8)
    return ctx2, qsv


@pytest.mark.parametrize("source", ["design", "blocks"])
def test_runtime_folds_the_tables(source):
    """The port's runtime builds ctx2 and qsv with the tables, from a
    design and from its serialized blocks, equal to the fold of its plain
    tables; tables_to_torch carries them as they are."""
    c0, cond = np_stats.conditional_counts(*_case(1200, 9, 3, 0.5, 5)[1:3],
                                           3)
    design = prt.Design(c0, cond, MODE_RATIO, 0.5,
                        make_matrix(DISTORTION_MSE))
    t = (design.tables() if source == "design" else
         prt.tables_from_blocks(design.serialized(), 3, 9))
    ctx2, qsv = _fold(t)
    assert np.array_equal(np.asarray(t.ctx2, np.int64), ctx2)
    assert np.array_equal(np.asarray(t.qsv, np.int64), qsv)
    tabs = tq.tables_to_torch(t, "cpu")
    assert np.array_equal(tabs["ctx2"].numpy(), ctx2.reshape(-1))
    assert np.array_equal(tabs["qsv"].numpy().view(np.uint16),
                          qsv.reshape(-1))
    assert np.array_equal(tabs["pair_bounds"].numpy(),
                          np.append(t.pair_base, t.n_pairs))


def test_tables_to_torch_plain_arrays_where_asked():
    """The plain version's arrays come by default on the CPU only, where
    the wrapper runs the plain version; `plain` sets it either way."""
    tables, *_ = _case(300, 4, 2, 0.5, 6)
    folded = {"columns", "n_clusters", "ctx2", "qsv", "pair_bounds",
              "max_pairs"}
    plain = {"ctxmap", "pair_base", "qratio", "qs_map", "qv_map"}
    assert set(tq.tables_to_torch(tables.port, "cpu")) == folded | plain
    assert set(tq.tables_to_torch(tables.port, "cpu", plain=False)) \
        == folded
    assert set(tq.tables_to_torch(tables.port, torch.device("cpu"),
                                  plain=True)) == folded | plain


def test_tables_to_torch_carries_tables():
    tables, *_ = _case(1500, 6, 3, 0.85, 91)
    tabs = tq.tables_to_torch(tables.port, "cpu")
    assert tabs["columns"] == 6 and tabs["n_clusters"] == 3
    for key, dtype in (("ctxmap", torch.int32), ("pair_base", torch.int32),
                       ("qratio", torch.uint8), ("qs_map", torch.uint8),
                       ("qv_map", torch.uint8)):
        t = tabs[key]
        assert t.dtype == dtype and t.dim() == 1, key
        assert np.array_equal(t.numpy(),
                              np.asarray(getattr(tables.port, key)).reshape(-1)
                              .astype(t.numpy().dtype)), key
    # copies, not views of the C++-owned storage
    tabs["qs_map"][0] += 1
    assert tabs["qs_map"][0].item() != int(tables.port.qs_map.reshape(-1)[0])


def test_quantize_rejects_bad_inputs():
    tables, data, clusters, draws = _case(200, 4, 1, 0.5, 1)
    tabs = tq.tables_to_torch(tables.port, "cpu")
    d = torch.from_numpy(np.ascontiguousarray(data.T))
    with pytest.raises(TypeError):
        tq.quantize_t_device(tabs, d.int(), d)
    with pytest.raises(ValueError):
        tq.quantize_t_device(tabs, d, d[:, :10])
    with pytest.raises(ValueError):
        tq.quantize_t_device(tabs, d[:3], d[:3])


def test_distortion_device_matches_host():
    tables, data, clusters, draws = _case(3000, 24, 1, 0.5, 12)
    dist = make_matrix(DISTORTION_MSE)
    _, _, qv = _port(tables, data, np.zeros(len(data), np.uint8), draws)
    exact = float(dist[data.reshape(-1), qv.T.reshape(-1)].sum())
    got = tq.distortion_device(torch.from_numpy(np.ascontiguousarray(data.T)),
                               torch.from_numpy(qv), dist)
    want = jx_quant.distortion_device(np.ascontiguousarray(data.T), qv, dist)
    # float32 sums per column: relative error well under 1e-6
    assert abs(got - exact) <= 1e-6 * exact
    assert abs(got - want) <= 1e-6 * exact


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(3000, 24, 3, 0.5, 41),
                                  (2000, 10, 20, 0.5, 20),
                                  (1037, 12, 3, 0.5, 37)],
                         ids=["3000x24c3", "2000x10c20", "1037x12c3"])
def test_quantize_kernel_geometries(geom):
    """K1 against the plain version with many clusters and with N not a
    multiple of its reads a thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    tables, data, clusters, draws = _case(*geom)
    cpu = _port(tables, data, clusters, draws)
    tabs = tq.tables_to_torch(tables.port, "cuda")
    args = (torch.from_numpy(np.ascontiguousarray(data.T)).cuda(),
            torch.from_numpy(np.ascontiguousarray(draws.T)).cuda(),
            torch.from_numpy(clusters).cuda())
    got = tq.quantize_t_device(tabs, *args)
    torch.cuda.synchronize()
    for a, b in zip(cpu, got):
        assert np.array_equal(a, b.cpu().numpy())


@pytest.mark.cuda
def test_quantize_kernel_matches_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    tables, data, clusters, draws = _case(3000, 24, 2, 0.5, 41)
    cpu = _port(tables, data, clusters, draws)
    tabs = tq.tables_to_torch(tables.port, "cuda")
    got = tq.quantize_t_device(
        tabs, torch.from_numpy(np.ascontiguousarray(data.T)).cuda(),
        torch.from_numpy(np.ascontiguousarray(draws.T)).cuda(),
        torch.from_numpy(clusters).cuda())
    torch.cuda.synchronize()
    for a, b in zip(cpu, got):
        assert np.array_equal(a, b.cpu().numpy())
