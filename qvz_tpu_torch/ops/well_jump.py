"""The start states of the QVZ2 encode's WELL streams on the device: KJ
(``csrc/well_jump.cu``) and its plain PyTorch version.

A stream of KW (``ops/well_draws.py``) starts `offset` pool words into
the file's one logical WELL-1024a stream. One word step is linear over
GF(2) on the 1,024-bit state, a matrix M, so the stream's state is
M^offset v0, v0 the file's state: the product of the matrices M^(2^k)
(``rt.well_pow_table``) for the set bits of its own offset. The host's
``rt.well_jump`` reaches the same states by a chain, each from the one
before it, on one thread; here every stream is jumped on its own. No TPU
kernel corresponds: ``qvz_tpu`` jumps on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qvz_tpu_torch import _build
from qvz_tpu_torch.native import runtime as rt

# streams the plain version multiplies at once (a (256, 1024, 16) int64
# product, 32 MB)
_CHUNK = 256


@functools.lru_cache(maxsize=None)
def table_t(device: torch.device) -> torch.Tensor:
    """The jump table M^(2^k), k = 0..63, on `device` as (64, 1024, 32)
    int32 (each row's 32 words in the state's word order), made and
    uploaded once a device and process: it depends on neither the state
    nor the plan."""
    return torch.from_numpy(rt.well_pow_table().view(np.int32)).to(device)


def _parity(x: torch.Tensor) -> torch.Tensor:
    """The parity of each int64, 0 or 1."""
    for sh in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> sh)
    return x & 1


def states_t_reference(v0: torch.Tensor, offsets: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of KJ on the tensors' device: v0 (32,) int32,
    offsets (T,) int64, table as ``table_t``; returns (T, 32) int32, row
    t the state offsets[t] words after v0. Bit i of M v is the parity of
    row i of M AND v, here in 16 words of 64 bits."""
    t64 = table.reshape(64, 1024, 32).view(torch.int64)
    v = v0.reshape(1, 32).view(torch.int64).repeat(len(offsets), 1)
    weights = torch.ones(64, dtype=torch.int64, device=v.device) \
        << torch.arange(64, device=v.device)
    for k in range(64):
        rows = torch.nonzero((offsets >> k) & 1).flatten()
        for c in range(0, len(rows), _CHUNK):
            idx = rows[c:c + _CHUNK]
            x = t64[k][None] & v[idx][:, None, :]
            for width in (8, 4, 2, 1):
                x = x[..., :width] ^ x[..., width:2 * width]
            bits = _parity(x[..., 0]).reshape(len(idx), 16, 64)
            v[idx] = (bits * weights).sum(-1)
    return v.view(torch.int32)


def _check(v0: np.ndarray, offsets: np.ndarray) -> None:
    if not isinstance(v0, np.ndarray) or v0.dtype != np.uint32:
        raise TypeError("v0 must be a uint32 numpy array of the state's "
                        "32 words")
    if v0.shape != (32,):
        raise ValueError(f"v0 {v0.shape}: the state's 32 words")
    if not isinstance(offsets, np.ndarray) or offsets.dtype != np.int64:
        raise TypeError("offsets must be an int64 numpy array")
    if offsets.ndim != 1:
        raise ValueError(f"offsets {offsets.shape}: one word offset a "
                         "stream")
    if len(offsets) and offsets.min() < 0:
        raise ValueError("a stream has a negative word offset")


def states_t(v0: np.ndarray, offsets: np.ndarray, device) -> torch.Tensor:
    """The (T, 32) int32 start states of T streams on `device` (KJ's
    contract): row t is the WELL-1024a state (n=0 semantics, the u32
    words' bits) offsets[t] pool words after v0, the file's state (32
    uint32 words, n=0 semantics, as ``rt.well_jump`` takes it), equal to
    what ``rt.well_jump`` gives there. offsets: (T,) int64 host array,
    non-negative. On the CPU the plain version; on a CUDA device KJ, after
    the offsets' upload (8 bytes a stream), or raises."""
    _check(v0, offsets)
    v0 = np.ascontiguousarray(v0)
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    offs = torch.from_numpy(offsets).to(device)
    if device.type == "cpu":
        return states_t_reference(torch.from_numpy(v0.view(np.int32)), offs,
                                  table_t(device))
    lib = _build.load()
    table = table_t(offs.device)
    out = torch.empty((len(offsets), 32), dtype=torch.int32,
                      device=offs.device)
    if len(offsets) == 0:
        return out
    _build.launch("well_jump", "WELL jump kernel", offs.device,
                  lib.qvz_well_jump_states, v0.ctypes.data,
                  table.data_ptr(), offs.data_ptr(), len(offsets),
                  out.data_ptr())
    return out
