"""qvz_tpu_torch.microbench against the TPU microbenchmark.

The three Pallas kernels of ``scripts/vpu_microbench.py`` and its NumPy
replays live inside its ``main()``; the tests take them out with ``ast``
(the script stays as it is), run them with ``pl.pallas_call(...,
interpret=True)`` on the CPU at small shapes, and hold the port's plain
versions (what its wrappers run on CPU tensors) element-equal to them.
"""

import ast
import pathlib
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qvz_tpu_torch import _build, roofline
from qvz_tpu_torch import microbench as mb

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "vpu_microbench.py"
REPS = 6
CH = 8
SHAPES = {"3d_w4": (64, 4, 128), "3d_w8": (64, 8, 128),
          "2d_w512": (64, 512)}
TAKEN = ("issue_kernel", "mix_kernel", "selmix_kernel", "_mix_replay",
         "_sel_replay")


def _script_main():
    tree = ast.parse(SCRIPT.read_text(), str(SCRIPT))
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


@pytest.fixture(scope="module")
def tpu():
    """The script's kernels and replays, exec'd as main() defines them."""
    nodes = [n for n in _script_main().body
             if isinstance(n, ast.FunctionDef) and n.name in TAKEN]
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, np=np, partial=partial,
              _I32=jnp.int32, _U32=jnp.uint32)
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(SCRIPT),
                 "exec"), ns)
    assert all(name in ns for name in TAKEN)
    return ns


def _pallas_issue(tpu, x, reps, op):
    return np.asarray(pl.pallas_call(
        partial(tpu["issue_kernel"], reps=reps, op=op),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        interpret=True)(x))


def _pallas_mix(tpu, kw, c, reps, mode=None):
    shape = kw.shape
    if mode is None:
        kernel = partial(tpu["mix_kernel"], ch=CH, nch=shape[0] // CH)
        oshape = shape[1:] if len(shape) == 3 else (1, shape[1])
    else:
        kernel = partial(tpu["selmix_kernel"], ch=CH, nch=shape[0] // CH,
                         mode=mode)
        oshape = shape[1:]
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(oshape, jnp.int32),
        scratch_shapes=[pltpu.VMEM(shape, jnp.int32)],
        interpret=True)(np.array([reps], np.int32), kw, c))


def _port(mode, reps, kw, c):
    kwt, ct = torch.from_numpy(kw), torch.from_numpy(c)
    if mode is None:
        return mb.mix(reps, kwt, ct).numpy()
    return mb.selmix(reps, kwt, ct, mode).numpy()


@pytest.mark.parametrize("op", ["addxor", "cmpsel"])
def test_issue_equals_pallas(tpu, op):
    x = mb.issue_input()
    want = _pallas_issue(tpu, x.numpy(), REPS, op)
    got = mb.issue(x, REPS, op, tiles=2)
    assert got.shape == (2, 8, 128) and got.dtype == torch.int32
    for tile in got.numpy():
        assert np.array_equal(tile, want)


@pytest.mark.parametrize("op", ["addxor", "cmpsel"])
def test_issue_wraps_like_pallas(tpu, op):
    """Chains that pass 2^31 wrap as the TPU's int32 arithmetic does."""
    x = np.full((8, 8, 128), 2 ** 31 - 9, np.int32)
    x[:, :, ::2] = -(2 ** 31) + 3
    want = _pallas_issue(tpu, x, REPS, op)
    got = mb.issue(torch.from_numpy(x), REPS, op)[0].numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_mix_equals_pallas(tpu, layout):
    kw, c, _, _ = mb.mix_input(SHAPES[layout])
    want = _pallas_mix(tpu, kw, c, REPS)
    got = _port(None, REPS, kw, c)
    assert got.shape == want.shape and got.dtype == np.int32
    assert np.array_equal(got, want)
    assert mb.checksum(torch.from_numpy(got)) == tpu["_mix_replay"](
        kw, c, REPS)


@pytest.mark.parametrize("layout", sorted(SHAPES))
@pytest.mark.parametrize("mode", ["sel", "sel_b4", "sweeponly"])
def test_selmix_equals_pallas(tpu, mode, layout):
    kw, c, _, _ = mb.mix_input(SHAPES[layout])
    want = _pallas_mix(tpu, kw, c, REPS, mode)
    got = _port(mode, REPS, kw, c)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert mb.checksum(torch.from_numpy(got)) == tpu["_sel_replay"](
        kw, c, REPS, mode)


@pytest.mark.parametrize("mode", [None, "sel_b4"])
def test_mix_wraps_like_pallas(tpu, mode):
    """Counts near 2^31: the masked sums wrap mod 2^32 on both sides."""
    kw, c, _, _ = mb.mix_input(SHAPES["3d_w8"])
    c = (c + (2 ** 31 - 5000)).astype(np.int32)
    want = _pallas_mix(tpu, kw, c, REPS, mode)
    assert np.array_equal(_port(mode, REPS, kw, c), want)


@pytest.mark.parametrize("mode", ["mix", "sel", "sel_b4", "sweeponly"])
def test_replays_equal_the_scripts(tpu, mode):
    """The port's copies of the replays give the script's checksums, over
    enough reps to wrap qs (64) and m (8 values)."""
    kw, c, _, _ = mb.mix_input((16, 8, 128))
    if mode == "mix":
        assert mb._mix_replay(kw, c, 70) == tpu["_mix_replay"](kw, c, 70)
    else:
        assert mb._sel_replay(kw, c, 70, mode) == tpu["_sel_replay"](
            kw, c, 70, mode)


def test_plain_sel_equals_plain_mix():
    """By products or by selects, the mix is one function."""
    _, _, kw, c = mb.mix_input((16, 4, 128))
    assert torch.equal(mb.selmix(40, kw, c, "sel"), mb.mix(40, kw, c))


def test_leg_table_is_the_scripts():
    """LEGS holds the legs the script runs (vpu_microbench.py:361-378):
    tags, shapes, reps, ops an element and modes."""
    legs = {}
    for node in ast.walk(_script_main()):
        if isinstance(node, ast.For) and "run_mix" in ast.unparse(node.body):
            for tag, shape, reps in ast.literal_eval(node.iter):
                legs[tag] = ("mix", "mix", shape, reps, mb.OPS_PER_ELEM)
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "safe"):
            continue
        fn = node.args[0].id
        vals = [eval(compile(ast.Expression(a), "leg", "eval"))
                for a in node.args[1:] if not isinstance(a, ast.Name)]
        if fn == "run_issue":
            tag, op, reps, ops = vals
            legs[tag] = ("issue", op, None, reps, ops)
        elif fn == "run_sel":
            tag, shape, reps, mode, ops = vals
            legs[tag] = ("selmix", mode, shape, reps, ops)
    assert len(legs) == 9
    assert {leg.tag: tuple(leg)[1:] for leg in mb.LEGS} == legs
    assert set(mb.NAMED.values()) <= set(legs)


def test_kernel_entry_has_the_contract_keys():
    """An entry of chip_smoke.py's kernels line, without the launches it
    adds: the named leg's times and its bound, the slowest pipe for the
    SASS of the kernel's loop against the bytes over the memory rate."""
    leg = next(leg for leg in mb.LEGS if leg.tag == mb.NAMED["mix"])
    gpu = roofline.Card("H100", 132, 1.98e9)
    per_elem = {"issue": 14, "alu": 5.25, "fma": 5, "shared": 3}
    elems = 8000 * 512 * 1024
    e = mb._entry(leg, 3.0, 800.0, roofline.pipe_bound(
        gpu, per_elem, elems, 4 * (2 * 512 * 1024 + 1024)))
    assert set(e) >= {"name", "route", "source", "replaces", "ms",
                      "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert e["replaces"] == "scripts/vpu_microbench.py:198"
    assert (ROOT / e["source"]).exists() and e["route"] == "cuda"
    assert e["bound_by"] == "operations" and e["library_ms"] is None
    assert e["bound_pipe"] == "issue"
    assert e["bound_ms"] == pytest.approx(
        14 * elems / (132 * 128 * 1.98e9) * 1e3)


def test_out_is_not_the_tpu_record():
    assert mb.OUT == ROOT / "build" / "microbench_torch.json"
    assert mb.OUT != ROOT / "build" / "vpu_microbench.json"


@pytest.mark.parametrize("shape", [(1024, 4, 128), (512, 8, 128),
                                   (1024, 512), (512, 1024)])
def test_card_shape_fills_shared_memory(shape):
    """The card-wide leg keeps the trailing shape and fills about 200 KB
    of shared memory an SM at BLOCKS_PER_SM blocks, each within 227 KB."""
    sms = 132
    big = mb.card_shape(shape, sms)
    P = int(np.prod(shape[1:]))
    assert big[1:] == shape[1:]
    rpb = mb.rows_per_block(big[0], sms)
    assert rpb * mb.BLOCKS_PER_SM * sms == big[0]
    per_sm = rpb * P * 8 * mb.BLOCKS_PER_SM
    assert 180 * 1024 <= per_sm <= mb.FILL_BYTES
    assert rpb * P * 8 <= mb.MAX_SHARED
    # the TPU's shape: every row on a block, 2 blocks an SM at most
    assert mb.rows_per_block(shape[0], sms) * 2 * sms >= shape[0]


def test_wrappers_reject_bad_inputs():
    x = mb.issue_input()
    with pytest.raises(ValueError):
        mb.issue(x, 4, "mul")
    with pytest.raises(TypeError):
        mb.issue(x.long(), 4, "addxor")
    _, _, kw, c = mb.mix_input((8, 4, 128))
    with pytest.raises(ValueError):
        mb.selmix(4, kw, c, "mix")
    with pytest.raises(ValueError):
        mb.mix(4, kw, c[:4])
    with pytest.raises(TypeError):
        mb.mix(4, kw.long(), c)
    with pytest.raises(ValueError):
        mb.mix(4, kw.to("meta"), c.to("meta"))


def test_run_legs_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mb.run_legs("cuda")
    with pytest.raises(ValueError):
        mb.run_legs("cpu")


SASS = """
        Function : qvz_mb_mix
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDS R4, [R3] ;
        /*0030*/                   LDS R5, [R3+0x800] ;
        /*0040*/                   IADD3 R6, R5, -R2, RZ ;
        /*0050*/                   ISETP.GE.U32.AND P0, PT, R6, R7, PT ;
        /*0060*/                   SEL R8, RZ, 0x1, P0 ;
        /*0070*/                   IMAD R9, R4, R8, R9 ;
        /*0080*/                   STS [R3], R4 ;
        /*0090*/              @!P1 BRA 0x20 ;
        /*00a0*/                   ISETP.NE.AND P2, PT, R0, RZ, PT ;
        /*00b0*/              @P2 BRA 0x10 ;
        /*00c0*/                   EXIT ;
"""


def test_inner_loop_of_sass():
    insns = [(int(m.group(1), 16), m.group(2), m.group(3))
             for m in map(mb._INSN.match, SASS.splitlines()) if m]
    counts, pipes = mb._inner_loop(insns)
    assert counts == {"IADD3": 1, "LOP3": 0, "ISETP": 1, "SEL": 1, "LEA": 0,
                      "VIADD": 0, "IMAD": 1, "LDS": 2, "STS": 1, "total": 8}
    assert pipes == {"issue": 8, "alu": 3, "fma": 1, "shared": 3}


def _fake_function(sym, body):
    lines = [f"        Function : {sym}",
             "        /*0000*/                   S2R R0, SR_TID.X ;"]
    for i, op in enumerate(body):
        lines.append(f"        /*{16 * (i + 1):04x}*/                   "
                     f"{op} R1, R2, R3 ;")
    lines.append(f"        /*{16 * (len(body) + 1):04x}*/              "
                 "@!P1 BRA 0x10 ;")
    lines.append(f"        /*{16 * (len(body) + 2):04x}*/"
                 "                   EXIT ;")
    return "\n".join(lines)


def _fake_sass():
    issue = ["LOP3"] * 8 + ["ISETP.GT.AND"] * 8 + ["IADD3"] * 8
    mixb = ["LDS", "LDS", "IADD3", "ISETP.GE.U32.AND", "IMAD.IADD", "STS"]
    return "\n".join(_fake_function(sym, issue if v in mb.ISSUE_OPS else
                                    ["LDS.64", "IADD3"]
                                    if v == "sweeponly" else mixb)
                     for v, sym in mb.SYMBOLS.items())


def test_sass_loops_count_per_element(monkeypatch):
    """Instructions an element, by pipe: a thread-rep of the 8 chains for
    the issue kernels, a store of c for the mix, a step for sel_b4 (4 a
    store), a load for the sweep; shared words by the access's width."""
    text = _fake_sass()
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(_build, "nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(mb.subprocess, "run",
                        lambda *a, **k: type("R", (), {"stdout": text}))
    got = mb.sass_loops()
    issue = {"issue": 25, "alu": 24, "fma": 0, "shared": 0}
    mixb = {"issue": 7, "alu": 2, "fma": 1, "shared": 3}
    assert {v: c["per_elem"] for v, c in got.items()} == {
        "addxor": issue, "cmpsel": issue, "mix": mixb, "sel": mixb,
        "sel_b4": {k: v / 4 for k, v in mixb.items()},
        "sweeponly": {"issue": 3, "alu": 1, "fma": 0, "shared": 2}}
    assert got["mix"]["LDS"] == 2 and got["mix"]["total"] == 7


def test_sass_loops_builds_the_library_first(monkeypatch, tmp_path):
    """With no library for this source hash, sass_loops builds it before
    it reads the library's SASS."""
    lib = tmp_path / "libqvz_cuda_0.so"
    built = []

    def build(path, lineinfo=False):
        assert not lineinfo
        built.append(path)
        path.write_bytes(b"")
        return ""

    def run(cmd, **kw):
        assert cmd[-1] == str(lib) and lib.exists(), "read before the build"
        return type("R", (), {"stdout": _fake_sass()})

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "lib_path", lambda lineinfo=False: lib)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: mock.MagicMock())
    monkeypatch.setattr(_build, "nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(mb.subprocess, "run", run)
    assert set(mb.sass_loops()) == set(mb.SYMBOLS)
    assert built == [lib]


@pytest.mark.cuda
def test_kernels_on_the_card():
    """Each kernel equals its plain version on the card at reps 6 and
    counts its launch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    x = mb.issue_input("cuda")
    before = dict(_build.LAUNCHES)
    for op in ("addxor", "cmpsel"):
        assert torch.equal(mb.issue(x, REPS, op, tiles=3),
                           mb.issue_reference(x, REPS, op, 3))
    _, _, kw, c = mb.mix_input(SHAPES["3d_w8"], "cuda")
    assert torch.equal(mb.mix(REPS, kw, c), mb.mix_reference(REPS, kw, c))
    for mode in ("sel", "sel_b4", "sweeponly"):
        assert torch.equal(mb.selmix(REPS, kw, c, mode),
                           mb.selmix_reference(REPS, kw, c, mode))
    assert _build.LAUNCHES["issue"] == before.get("issue", 0) + 2
    assert _build.LAUNCHES["mix"] == before.get("mix", 0) + 1
    assert _build.LAUNCHES["selmix"] == before.get("selmix", 0) + 3


LOOPS = """
        Function : k
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0020*/               @P0 BRA 0x70 ;
        /*0030*/                   LDS.U16 R2, [R3] ;
        /*0040*/                   IMAD R3, R2, R4, R3 ;
        /*0050*/              @!P2 BRA 0x30 ;
        /*0060*/                   STS.U16 [R4], R2 ;
        /*0070*/                   LOP3.LUT R5, R5, R2, RZ, 0xfc, !PT ;
        /*0080*/               @PT BRA 0x90 ;
        /*0090*/                   ISETP.GE.AND P1, PT, R1, R6, PT ;
        /*00a0*/              @!P1 BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""


def test_trip_min_takes_the_shortest_trip(monkeypatch):
    """A trip's least instructions by pipe: the branch around the body
    skips it; `through` forces the body; the nested loop counts nothing in
    the outer one; an @PT branch is unconditional."""
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(_build, "nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(mb.subprocess, "run",
                        lambda *a, **k: type("R", (), {"stdout": LOOPS}))
    insns = mb.sass_functions()["k"]
    assert [i[3] for i in insns] == [False, False, True, False, False, True,
                                     False, False, False, False, True, False]
    assert mb.loop_spans(insns) == {0x10: 0xa0, 0x30: 0x50}
    assert mb.trip_min(insns, 0x10) == {"issue": 6, "alu": 3, "fma": 0,
                                        "shared": 0}
    assert mb.trip_min(insns, 0x10, "STS") == {"issue": 7, "alu": 3,
                                               "fma": 0, "shared": 0.5}
    assert mb.trip_min(insns, 0x30) == {"issue": 3, "alu": 0, "fma": 1,
                                        "shared": 0.5}
    with pytest.raises(RuntimeError, match="no MUFU"):
        mb.trip_min(insns, 0x10, "MUFU")


@pytest.mark.parametrize("op,shared", [
    ("ATOMS.POPC.INC.32", 1), ("ATOMS.ADD", 1), ("ATOMS.ADD.64", 2),
    ("LDS.128", 4), ("STS.U8", 0.25), ("ATOM.E.ADD.64", 0),
    ("REDG.E.ADD.64.STRONG.GPU", 0)])
def test_shared_atomics_count_as_shared_words(op, shared):
    """A shared-memory atomic moves its word through the shared-memory
    pipe, as a load or store of that width does; device-memory atomics
    move none."""
    assert mb._weights(op)["shared"] == shared
    assert mb._weights(op)["issue"] == 1
