"""qvz_tpu_torch: the QVZ2 device encode and decode of qvz_tpu in PyTorch
and CUDA.

A port of qvz_tpu's sharded QVZ2 device encode and decode for one NVIDIA
H100: k-means clustering, statistics, quantization and lane-parallel
entropy coding run on the card and produce containers byte-identical to
qvz_tpu's, and lane-parallel entropy decoding gives the host decoder's
bytes. Its drivers are qvz_tpu's too: the bounded-memory streaming
encode (``pipeline/streaming.py``: statistics chunk by chunk and the
quantization shard by shard on the card, the coding on host threads),
which the CLI takes by itself for an input of 1 GiB or more, and the
multi-host encode and decode across worker processes
(``parallel/multihost.py``). The kernels are
CUDA C++ under ``csrc/`` (built on first use, see ``_build``); every one
has a plain PyTorch version beside it, which the wrappers use for tensors
on the CPU.

The package stands alone: it imports neither JAX nor anything of
qvz_tpu. It carries its own copies of what it needs from there, under
the same module names: the host C++ runtime (``native/``, built with g++
on first use), the container formats (``format/``), the WELL state and
distortion matrices (``ops/well.py``, ``ops/distortion.py``), the
k-means seeds and quality-file I/O (``spec/``) and the host engine
(``pipeline/host.py``), which codes the v1 container, decodes the
containers without lanes and is the reference of the device paths.

Across devices, ``pipeline.encode.encode(..., mesh=parallel.mesh.make_mesh
(...))`` runs the k-means, statistics, quantization and lane coding on one
block of reads a device, merging only integer counts
(``parallel/sharded.py``); ``parallel/distributed.py`` reduces the
statistics across processes over torch.distributed. ``tools/`` holds the
host-only container transcoder (v1 <-> QVZ2), the distortion checker and
the FASTQ quality-line tool.
"""

__version__ = "0.1.0"

from qvz_tpu_torch.constants import (  # noqa: F401
    ALPHABET_SIZE,
    MODE_FIXED,
    MODE_RATIO,
    DISTORTION_MSE,
    DISTORTION_LORENTZ,
    DISTORTION_MANHATTAN,
    DISTORTION_CUSTOM,
)
