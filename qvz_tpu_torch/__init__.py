"""qvz_tpu_torch: the QVZ2 device encode and decode of qvz_tpu in PyTorch
and CUDA.

A port of qvz_tpu's sharded QVZ2 device encode and decode for one NVIDIA
H100: k-means clustering, statistics, quantization and lane-parallel
entropy coding run on the card and produce containers byte-identical to
qvz_tpu's, and lane-parallel entropy decoding gives the host decoder's
bytes. The kernels are
CUDA C++ under ``csrc/`` (built on first use, see ``_build``); every one
has a plain PyTorch version beside it, which the wrappers use for tensors
on the CPU.

The parts of qvz_tpu that import no JAX are reused read-only: the C++
runtime (``qvz_tpu.native``), the container formats, the WELL state, the
distortion matrices and the host decoder. This package never imports
JAX.
"""

__version__ = "0.1.0"
