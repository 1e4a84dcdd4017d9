"""The QVZ2 encode's 7-bit dither draws on the device: KW
(``csrc/well.cu``) and its plain PyTorch version.

The draws of a file come from one logical WELL-1024a stream split at
pool-word boundaries: shard s starts from its GF(2) jump-ahead state
(``pipeline.host.shard_plan``) with an empty pool, and its draws fill its
lines in (line, column) order, four from each 32-bit pool word and the
word's last 4 bits thrown away (``rt.well_draws7``, reference
src/well.c:33-46). ``stream_offsets`` cuts the plan's shards into KW's
streams (``stream_plan`` also gives their states from the host's jump;
the device encode has KJ make them, ``ops/well_jump.py``), and
``draws_t`` writes a block's draws as the (cols, N) uint8 array that K1
reads. No TPU kernel corresponds: ``qvz_tpu`` fills the draws on the
host (``pipeline.host._shard_draws`` here) and copies them to the
device.

This module holds no WELL state of its own (``ops/well.py``, which the
host engine imports without torch, holds it).
"""

from __future__ import annotations

import numpy as np
import torch

from qvz_tpu_torch import _build
from qvz_tpu_torch.native import runtime as rt

_M32 = 0xFFFFFFFF
# the bit offsets of a pool word's four draws
_SHIFTS = (0, 7, 14, 21)
# words the plain version advances between two conversions to draws (a
# multiple of 32, so each chunk starts at rotating index 0)
_CHUNK_WORDS = 4096


def _piece(counts) -> int:
    """The lines of a piece: the longest lane rounded up to a multiple of
    4 (the lanes are the shards after the first where the plan has more
    than one)."""
    lanes = counts[1:] if len(counts) > 1 else counts
    return (int(max(lanes)) + 3) & ~3


def stream_offsets(counts, columns: int):
    """KW's streams for a QVZ2 plan of shards of lines `counts`, from the
    counts alone: each shard one stream, except that a shard of more lines
    than a piece, P lines (``_piece``; the warmup shard of a primed plan),
    is cut into pieces of P lines, the last ragged. Every shard but the
    last, and P, is a multiple of 4 lines, so every stream starts on a
    pool word. Returns (each stream's word offset into the file's WELL
    stream (T,) int64, its lines (T,) int64, the index of each shard's
    first stream (S,) int64), in the order of the lines."""
    c = np.asarray(counts, dtype=np.int64)
    piece = _piece(c)
    k = np.maximum(1, -(-c // piece))
    first = np.concatenate([[0], np.cumsum(k)[:-1]]).astype(np.int64)
    shard = np.repeat(np.arange(len(c)), k)
    i = np.arange(len(shard), dtype=np.int64) - first[shard]
    start = (np.cumsum(c) - c)[shard] + i * piece
    return (start * columns // 4, np.minimum(piece, c[shard] - i * piece),
            first)


def stream_plan(states: np.ndarray, counts, columns: int):
    """KW's streams (``stream_offsets``) for a QVZ2 plan of shards with
    start states (S, 32) uint32 and lines `counts`, a cut shard's pieces
    from the states rt.well_jump gives P x columns / 4 pool words apart.
    Returns (states (T, 32) uint32, lines (T,) int64), in the order of
    the lines."""
    _, lines, first = stream_offsets(counts, columns)
    step = _piece(counts) * columns // 4
    out_states = []
    for state, k in zip(np.asarray(states, dtype=np.uint32),
                        np.diff(np.append(first, len(lines)))):
        out_states.append(state[None, :] if k == 1
                          else rt.well_jump(state, int(k), step))
    return np.concatenate(out_states).astype(np.uint32), lines


def _offsets(lines, device) -> torch.Tensor:
    return torch.as_tensor(np.concatenate([[0], np.cumsum(lines)])
                           .astype(np.int64), device=device)


def _words_reference(s: torch.Tensor, n_words: int) -> torch.Tensor:
    """n_words successive outputs of the (S, 32) int64 states (index 0,
    words below 2^32) advanced in lockstep, (S, n_words) int64; leaves `s`
    advanced, its rotating index back at 0 where n_words is a multiple of
    32 (``qvz_tpu.ops.well.well_words_vectorized`` in torch)."""
    out = torch.empty((s.shape[0], n_words), dtype=torch.int64,
                      device=s.device)
    n = 0
    for i in range(n_words):
        m = (n + 31) & 31
        z0 = s[:, m]
        vm1, vm2, vm3 = s[:, (n + 3) & 31], s[:, (n + 24) & 31], \
            s[:, (n + 10) & 31]
        z1 = s[:, n] ^ vm1 ^ (vm1 >> 8)
        z2 = vm2 ^ ((vm2 << 19) & _M32) ^ vm3 ^ ((vm3 << 14) & _M32)
        w = (z0 ^ ((z0 << 11) & _M32) ^ z1 ^ ((z1 << 7) & _M32)
             ^ z2 ^ ((z2 << 13) & _M32))
        s[:, n] = z1 ^ z2
        s[:, m] = w
        out[:, i] = w
        n = m
    return out


def draws_t_reference(states: torch.Tensor, lines, columns: int
                      ) -> torch.Tensor:
    """Plain PyTorch version of KW: the streams advanced in lockstep on
    the states' device (as ``qvz_tpu.ops.well``'s
    ``well_words_vectorized`` and ``draws_from_words`` do), each word's
    four draws, and stream j's first lines[j] x columns draws written to
    its lines of the (columns, sum(lines)) uint8 output, transposed."""
    dev = states.device
    lines = [int(x) for x in lines]
    need = [-(-x * columns // 4) for x in lines]
    total = max(need, default=0)
    s = states.long() & _M32
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=dev)
    draws = torch.empty((len(lines), 4 * total), dtype=torch.uint8,
                        device=dev)
    for w0 in range(0, total, _CHUNK_WORDS):
        k = min(_CHUNK_WORDS, total - w0)
        words = _words_reference(s, k)
        draws[:, 4 * w0:4 * (w0 + k)] = (
            (words[:, :, None] >> shifts) & 0x7F).reshape(len(lines), -1)
    out = torch.empty((columns, sum(lines)), dtype=torch.uint8, device=dev)
    lo = 0
    for j, x in enumerate(lines):
        out[:, lo:lo + x] = draws[j, :x * columns].reshape(x, columns).t()
        lo += x
    return out


def _check(states: torch.Tensor, lines, columns: int) -> None:
    if states.dtype != torch.int32:
        raise TypeError("states must be int32 (the bits of the u32 words)")
    if states.dim() != 2 or states.shape != (len(lines), 32):
        raise ValueError(f"states {tuple(states.shape)}: one 32-word state "
                         f"for each of the {len(lines)} streams")
    if columns < 1:
        raise ValueError("columns must be positive")
    if any(int(x) < 0 for x in lines):
        raise ValueError("a stream has a negative line count")


def draws_t(states: torch.Tensor, lines, columns: int) -> torch.Tensor:
    """The (columns, sum(lines)) uint8 dither draws of the streams (KW's
    contract): stream j's lines lines[:j].sum() .. + lines[j] - 1 hold the
    draws of the WELL-1024a stream from states[j] (32 words, index 0, as
    int32 bits), one line's `columns` draws after another. lines: host
    ints. CPU tensors take the plain version; CUDA tensors launch KW
    (csrc/well.cu), or raise."""
    _check(states, lines, columns)
    dev = states.device
    if dev.type == "cpu":
        return draws_t_reference(states, lines, columns)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load()
    n = int(np.sum(lines, dtype=np.int64))
    out = torch.empty((columns, n), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    states = states.contiguous()
    offs = _offsets(lines, dev)
    _build.launch("well_draws", "WELL draw kernel", dev, lib.qvz_well_draws,
                  states.data_ptr(), offs.data_ptr(), len(lines), columns, n,
                  out.data_ptr())
    return out
