"""Loader of the port's host C++ runtime (``qvz_rt.cpp``).

A copy of ``qvz_tpu/native/__init__.py`` that builds into the repository:
on first use ``g++`` compiles ``qvz_rt.cpp`` into
``build/native/libqvz_rt_<sha16 of the sources and flags>.so`` under the
repository root, loaded with ctypes. A changed source gets a new hash and
so a new build; ``rm -rf build/native`` forces one. A failed build raises.

Bit-exactness requires the flags as they are: no -march=native (keeps FMA
contraction impossible on baseline x86-64, matching the reference build)
and -ffp-contract=off, which decide the codebook's double sums and so the
container's bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile

_DIR = pathlib.Path(__file__).parent
_SRC = _DIR / "qvz_rt.cpp"
_HDR = _DIR / "qvz_rt.h"
BUILD_DIR = _DIR.parent.parent / "build" / "native"

CXXFLAGS = [
    "-O3", "-std=c++17", "-shared", "-fPIC",
    # AVX2 for the integer hot loops (x86 only — non-x86 hosts build
    # with the compiler's baseline arch). FP results stay bit-identical
    # to the reference: contraction is off (no FMA fusing) and gcc never
    # reorders FP reductions without -ffast-math, so double summation
    # order — which decides discrete codebook outcomes — is preserved.
    *(["-march=x86-64-v3"] if platform.machine() in ("x86_64", "AMD64")
      else []),
    "-ffp-contract=off", "-fno-fast-math",
    "-Wall",
]


def lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_HDR.read_bytes())
    return BUILD_DIR / f"libqvz_rt_{h.hexdigest()[:16]}.so"


def build(path: pathlib.Path) -> None:
    """Compile the runtime into `path`; raises with g++'s output."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as td:
        tmp = pathlib.Path(td) / path.name
        cmd = ["g++", *CXXFLAGS, f"-I{_DIR}", "-o", str(tmp), str(_SRC)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, path)


_lib = None


def load() -> ctypes.CDLL:
    """The runtime library, built first if this source hash has none."""
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))

    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    u16p = c.POINTER(c.c_uint16)
    u32p = c.POINTER(c.c_uint32)
    u64p = c.POINTER(c.c_uint64)
    i32p = c.POINTER(c.c_int32)
    i64p = c.POINTER(c.c_int64)
    dp = c.POINTER(c.c_double)

    lib.qvz_well_draws7.argtypes = [u32p, c.c_uint64, u8p]
    lib.qvz_well_draws7.restype = None
    lib.qvz_encode_lines.argtypes = [
        u8p, u32p, u8p, c.c_uint64, c.c_uint32, u32p, c.c_uint32, u8p,
        c.c_int64]
    lib.qvz_encode_lines.restype = c.c_int64
    lib.qvz_well_jump.argtypes = [u32p, c.c_uint32, c.c_uint64, u32p]
    lib.qvz_well_jump.restype = None
    lib.qvz_well_pow_table.argtypes = [u64p]
    lib.qvz_well_pow_table.restype = None

    lib.qvz_xxh64.argtypes = [u8p, c.c_uint64, c.c_uint64]
    lib.qvz_xxh64.restype = c.c_uint64

    lib.qvz_design_create.argtypes = [
        u64p, u64p, c.c_uint32, c.c_uint32, c.c_int32, c.c_double, dp]
    lib.qvz_design_create.restype = c.c_void_p
    lib.qvz_design_serialized_size.argtypes = [c.c_void_p]
    lib.qvz_design_serialized_size.restype = c.c_int64
    lib.qvz_design_serialized.argtypes = [c.c_void_p, u8p]
    lib.qvz_design_serialized.restype = None
    lib.qvz_design_stats.argtypes = [c.c_void_p, i64p]
    lib.qvz_design_stats.restype = None
    lib.qvz_design_free.argtypes = [c.c_void_p]
    lib.qvz_design_free.restype = None

    lib.qvz_tables_from_design.argtypes = [c.c_void_p]
    lib.qvz_tables_from_design.restype = c.c_void_p
    lib.qvz_tables_from_blocks.argtypes = [
        u8p, c.c_int64, c.c_uint32, c.c_uint32]
    lib.qvz_tables_from_blocks.restype = c.c_void_p
    lib.qvz_tables_free.argtypes = [c.c_void_p]
    lib.qvz_tables_free.restype = None
    for name, rt in [
        ("qvz_tables_n_pairs", c.c_uint64),
        ("qvz_tables_n_models", c.c_uint32),
        ("qvz_tables_consumed", c.c_int64),
        ("qvz_tables_model_syms_len", c.c_uint64),
        ("qvz_tables_bank_words", c.c_uint64),
        ("qvz_tables_pair_base", u32p),
        ("qvz_tables_ctxmap", i32p),
        ("qvz_tables_qratio", u8p),
        ("qvz_tables_model_card", u32p),
        ("qvz_tables_model_off", u64p),
        ("qvz_tables_model_syms", u8p),
        ("qvz_tables_qv_map", u8p),
        ("qvz_tables_qs_map", u8p),
        ("qvz_tables_ctx2", u32p),
        ("qvz_tables_qsv", u16p),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = [c.c_void_p]
        fn.restype = rt

    lib.qvz_stats.argtypes = [u8p, c.c_uint64, c.c_uint32, u8p, u64p, u64p]
    lib.qvz_stats.restype = None
    lib.qvz_kmeans_iter.argtypes = [
        u8p, c.c_uint64, c.c_uint32, i64p, c.c_uint32, u8p, i64p, i64p]
    lib.qvz_kmeans_iter.restype = None

    lib.qvz_quantize_colmajor.argtypes = [
        c.c_void_p, u8p, c.c_uint64, u8p, u32p, dp, u8p, dp, u32p, u8p]
    lib.qvz_quantize_colmajor.restype = None
    lib.qvz_bank_from_stream.argtypes = [
        c.c_void_p, u32p, u8p, u8p, c.c_uint64, u32p]
    lib.qvz_bank_from_stream.restype = None
    lib.qvz_replay_model.argtypes = [
        u32p, c.c_uint32, c.c_uint32, u8p, c.c_uint64, u32p]
    lib.qvz_replay_model.restype = None

    lib.qvz_encode_fused.argtypes = [
        c.c_void_p, u8p, c.c_uint64, u8p, u32p, dp, u8p, dp, u8p,
        c.c_int64, c.c_int32]
    lib.qvz_encode_fused.restype = c.c_int64
    lib.qvz_encode_fused_colmajor.argtypes = [
        c.c_void_p, u8p, c.c_uint64, u8p, u32p, dp, u8p, dp, u8p,
        c.c_int64, u32p, u32p]
    lib.qvz_encode_fused_colmajor.restype = c.c_int64
    lib.qvz_encode_precomputed_colmajor.argtypes = [
        c.c_void_p, u32p, u8p, u8p, c.c_uint64, u8p, c.c_int64, u32p, u32p]
    lib.qvz_encode_precomputed_colmajor.restype = c.c_int64

    lib.qvz_decode_lines.argtypes = [
        c.c_void_p, u8p, c.c_uint64, c.c_uint64, u32p, u8p, u8p, c.c_int32]
    lib.qvz_decode_lines.restype = c.c_int32
    lib.qvz_decode_colmajor.argtypes = [
        c.c_void_p, u8p, c.c_uint64, c.c_uint64, u32p, u8p, u32p, u32p,
        u8p, u8p]
    lib.qvz_decode_colmajor.restype = c.c_int32
    lib.qvz_decode_cluster_prologue.argtypes = [
        c.c_void_p, u8p, c.c_uint64, c.c_uint64, u32p, u8p, u64p]
    lib.qvz_decode_cluster_prologue.restype = c.c_int32

    _lib = lib
    return lib
