"""Builds and loads the port's CUDA kernels.

On first use the sources in ``csrc/`` are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface,
``build/kernels/libqvz_cuda_<sha16 of the sources>.so`` under the
repository root, loaded with ``ctypes`` (the pattern of
``qvz_tpu/native/__init__.py``). A changed source gets a new hash and so
a new build; ``rm -rf build/kernels`` forces one. The ``ptxas`` report
(registers, spills) is kept beside the library as ``.log``.

``load(lineinfo=True)`` loads a second build of the same sources with
``-lineinfo`` added, ``libqvz_cuda_lineinfo_<sha16>.so``, whose
compute-sanitizer reports name source lines
(``scripts/sanitize_torch.py``); ``-lineinfo`` leaves the generated code
as it is, where ``-G`` would not.

A build failure raises. Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel launches per wrapper ("quantize", "coder_triples",
# "coder_chain" and "coder_segment" (K2a, K2b, K2s), "hist", "kmeans",
# "decoder" and "cluster_prologue" (K5, K5p), "well_draws" (KW),
# "well_jump" (KJ), and the microbenchmark's "issue", "mix" and
# "selmix"): each wrapper adds one where it launches its kernel, and
# nowhere else.
LAUNCHES: collections.Counter = collections.Counter()

_lib = None
_lib_lineinfo = False


def sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def nvcc_flags(lineinfo: bool = False) -> list[str]:
    return NVCC_FLAGS + (["-lineinfo"] if lineinfo else [])


def lib_path(lineinfo: bool = False) -> pathlib.Path:
    flags = nvcc_flags(lineinfo)
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    name = "libqvz_cuda_lineinfo_" if lineinfo else "libqvz_cuda_"
    return BUILD_DIR / f"{name}{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(pathlib.Path(home) / "bin" / "nvcc")] if home else []) \
            + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _start(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(cmd: list[str], proc: subprocess.Popen) -> str:
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return out


def build(path: pathlib.Path, lineinfo: bool = False) -> str:
    """Compile every source into `path`; returns the compiler's report."""
    flags = nvcc_flags(lineinfo)
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as td:
        tmp = pathlib.Path(td) / path.name
        objs = []
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            objs.append(str(pathlib.Path(td) / f"{src.stem}.o"))
            cmd = [nvcc(), *flags, "-c", str(src), "-o", objs[-1]]
            jobs.append((cmd, _start(cmd)))
        try:
            report = "".join(_finish(cmd, proc) for cmd, proc in jobs)
        finally:
            for _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        link = [nvcc(), *flags[:2], "-shared", "-o", str(tmp), *objs]
        report += _finish(link, _start(link))
        path.with_suffix(".log").write_text(report)
        os.replace(tmp, path)
    return report


def load(lineinfo: bool = False) -> ctypes.CDLL:
    """The kernel library, built first if this source hash has none. The
    first call of a process decides which build every wrapper launches
    from: lineinfo=True takes the line-info build, and asking for it
    after the plain build is loaded raises."""
    global _lib, _lib_lineinfo
    if _lib is not None:
        if lineinfo and not _lib_lineinfo:
            raise RuntimeError("the kernel library without -lineinfo is "
                               "already loaded in this process")
        return _lib
    path = lib_path(lineinfo)
    if not path.exists():
        build(path, lineinfo)
    lib = ctypes.CDLL(str(path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.qvz_quantize.argtypes = [p, p, p, i64, i32, p, p, p, p, p, p, p]
    lib.qvz_quantize.restype = ctypes.c_int
    lib.qvz_coder_smem_limits.argtypes = [p, p]
    lib.qvz_coder_smem_limits.restype = ctypes.c_int
    lib.qvz_coder_triples.argtypes = [p, p, i64, p, i32, i32, i32, i32, p,
                                      p, p, p, p, p, i32, p, i32, i32, p, p,
                                      p, p, p, i32, i32, i32, i32, i32, i64,
                                      p]
    lib.qvz_coder_triples.restype = ctypes.c_int
    lib.qvz_coder_chain.argtypes = [p, i32, i32, p, i32, p, i64, p, p,
                                    i32, p]
    lib.qvz_coder_chain.restype = ctypes.c_int
    lib.qvz_coder_segment.argtypes = [p, p, i32, i32, p, i32, i64, p, i32,
                                      p]
    lib.qvz_coder_segment.restype = ctypes.c_int
    lib.qvz_hist.argtypes = [p, p, i64, i32, i32, i32, i32, i64, i32, i32,
                             i32, p, p, p]
    lib.qvz_hist.restype = ctypes.c_int
    lib.qvz_kmeans_step.argtypes = [p, i64, i32, p, i32, i32, i32, i32, i32,
                                    i32, i64, i32, p, p, p]
    lib.qvz_kmeans_step.restype = ctypes.c_int
    lib.qvz_decode_lanes.argtypes = [p, p, p, p, i64, p, p, i32, i32, i32,
                                     p, i32, p, p, p, p, p, p, p, i32, p, p,
                                     p, p, i64, i32, p, i32, i32, p, p, p,
                                     p, i32, p, i32, i32, i32, i32, i32,
                                     i64, i64, i64, p]
    lib.qvz_decode_lanes.restype = ctypes.c_int
    lib.qvz_cluster_prologue.argtypes = [p, p, p, p, i32, p, i32, i64, p,
                                         p, p, i32, p]
    lib.qvz_cluster_prologue.restype = ctypes.c_int
    lib.qvz_decoder_smem_limit.argtypes = []
    lib.qvz_decoder_smem_limit.restype = ctypes.c_int
    lib.qvz_well_draws.argtypes = [p, p, i32, i32, i64, p, p]
    lib.qvz_well_draws.restype = ctypes.c_int
    lib.qvz_well_jump_states.argtypes = [p, p, p, i32, p, p]
    lib.qvz_well_jump_states.restype = ctypes.c_int
    lib.qvz_microbench_issue.argtypes = [p, i32, i32, i32, p, p]
    lib.qvz_microbench_issue.restype = ctypes.c_int
    lib.qvz_microbench_mix.argtypes = [i32, i32, p, p, i64, i32, i32, p, p]
    lib.qvz_microbench_mix.restype = ctypes.c_int
    _lib, _lib_lineinfo = lib, lineinfo
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def launch(kernel: str, what: str, device, entry, *args) -> None:
    """Launch `kernel` through the library's `entry` on the card of
    `device`, the device of the wrapper's tensors: that card is current
    for the call (an entry sets its kernel's attributes and launches on
    the current device) and its current stream goes last. A failure
    raises; a launch adds one to LAUNCHES[kernel]."""
    import torch     # here: the multi-host workers import this module
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    check(rc, what)
    LAUNCHES[kernel] += 1


def smem_limits() -> tuple[int, int]:
    """(shared-memory bytes one block may ask for, bytes one SM holds) on
    the current card."""
    block, sm = ctypes.c_int(0), ctypes.c_int(0)
    check(load().qvz_coder_smem_limits(ctypes.byref(block),
                                       ctypes.byref(sm)),
          "shared memory query")
    return block.value, sm.value
