"""WELL-1024a, the dither source of QVZ (src/well.c), in plain NumPy.

A state is 32 words in "n = 0" order (word i is s[(n + i) & 31]), the
form the QVZ2 container stores. ``step_words`` advances many streams in
lock step; ``grid_states`` gives the states at a regular grid of word
offsets by GF(2) jump-ahead (one step of the generator is a linear map
on the 1,024 state bits). Each 32-bit word yields four 7-bit draws, from
bits 0-6, 7-13, 14-20 and 21-27; the last 4 bits are dropped because the
pool is refilled before a draw that would need more than it holds
(well.c:33-46).
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32


def step_words(states: np.ndarray, n_words: int) -> np.ndarray:
    """Advance each of B streams (states (B, 32) uint32, n = 0 order) by
    n_words words; returns the words (n_words, B) uint32."""
    s = [np.array(states[:, i], dtype=_U32) for i in range(32)]
    out = np.empty((n_words, states.shape[0]), dtype=_U32)
    n = 0
    for k in range(n_words):
        z0 = s[(n + 31) & 31]
        vm1 = s[(n + 3) & 31]
        vm2 = s[(n + 24) & 31]
        vm3 = s[(n + 10) & 31]
        z1 = s[n] ^ vm1 ^ (vm1 >> _U32(8))
        z2 = vm2 ^ (vm2 << _U32(19)) ^ vm3 ^ (vm3 << _U32(14))
        s[n] = z1 ^ z2
        n = (n + 31) & 31
        s[n] = (z0 ^ (z0 << _U32(11)) ^ z1 ^ (z1 << _U32(7))
                ^ z2 ^ (z2 << _U32(13)))
        out[k] = s[n]
    return out


def draws_from_words(words: np.ndarray) -> np.ndarray:
    """(W, B) words -> (4W, B) uint8 draws, in stream order."""
    w = words[:, None, :] >> (np.array([0, 7, 14, 21], dtype=_U32)
                              [None, :, None])
    return (w & _U32(0x7F)).astype(np.uint8).reshape(-1, words.shape[1])


def _to_bits(states: np.ndarray) -> np.ndarray:
    """(B, 32) uint32 -> (1024, B) float32 bits, bit b of word w at
    32 * w + b."""
    bits = (states[:, :, None] >> np.arange(32, dtype=_U32)) & _U32(1)
    return bits.reshape(states.shape[0], 1024).T.astype(np.float32)


def _from_bits(bits: np.ndarray) -> np.ndarray:
    b = bits.T.reshape(-1, 32, 32).astype(np.uint32)
    return (b << np.arange(32, dtype=_U32)).sum(axis=2, dtype=np.uint64) \
        .astype(_U32)


def _gf2(x: np.ndarray) -> np.ndarray:
    return np.remainder(x, 2.0, dtype=np.float32)


class Jumper:
    """Powers of the one-word step matrix over GF(2), as 0/1 float32
    matrices (a product of two sums at most 1,024 ones, exact in
    float32)."""

    def __init__(self):
        basis = np.zeros((1024, 32), dtype=_U32)
        idx = np.arange(1024)
        basis[idx, idx // 32] = _U32(1) << (idx % 32).astype(_U32)
        # one word step of each basis state, read back in n = 0 order
        s = basis.copy()
        z0, vm1, vm2, vm3 = s[:, 31], s[:, 3], s[:, 24], s[:, 10]
        z1 = s[:, 0] ^ vm1 ^ (vm1 >> _U32(8))
        z2 = vm2 ^ (vm2 << _U32(19)) ^ vm3 ^ (vm3 << _U32(14))
        new = np.empty_like(s)
        new[:, 0] = (z0 ^ (z0 << _U32(11)) ^ z1 ^ (z1 << _U32(7))
                     ^ z2 ^ (z2 << _U32(13)))
        new[:, 1] = z1 ^ z2
        new[:, 2:] = s[:, 1:31]
        self.pow = [_to_bits(new)]          # column k = step(e_k)

    def power2(self, i: int) -> np.ndarray:
        while len(self.pow) <= i:
            p = self.pow[-1]
            self.pow.append(_gf2(p @ p))
        return self.pow[i]

    def matrix(self, k: int) -> np.ndarray:
        out = None
        i = 0
        while k:
            if k & 1:
                p = self.power2(i)
                out = p if out is None else _gf2(p @ out)
            k >>= 1
            i += 1
        return out if out is not None else np.eye(1024, dtype=np.float32)

    def jump(self, states: np.ndarray, k: int) -> np.ndarray:
        """Each of (B, 32) states advanced by k words."""
        v = _to_bits(states)
        i = 0
        while k:
            if k & 1:
                v = _gf2(self.power2(i) @ v)
            k >>= 1
            i += 1
        return _from_bits(v)

    def grid_states(self, state: np.ndarray, start: int, step: int,
                    count: int) -> np.ndarray:
        """The states at word offsets start + j * step, j < count, of the
        stream that starts at `state` (32,) -> (count, 32)."""
        base = _to_bits(self.jump(np.asarray(state, _U32)[None, :], start))
        j = self.matrix(step)
        v = base
        while v.shape[1] < count:
            v = np.concatenate([v, _gf2(j @ v)], axis=1)
            j = _gf2(j @ j)
        return _from_bits(v[:, :count])


def stream_draws(jumper: Jumper, state: np.ndarray, n_draws: int,
                 chunk_words: int = 1024) -> np.ndarray:
    """The first n_draws (a multiple of 4) draws of the stream that
    starts at `state`, made as streams of chunk_words words each, side by
    side, from their jump-ahead start states."""
    n_words = n_draws // 4
    n_chunks = -(-n_words // chunk_words)
    starts = jumper.grid_states(state, 0, chunk_words, n_chunks)
    words = step_words(starts, chunk_words)          # (chunk, chunks)
    flat = np.ascontiguousarray(words.T).reshape(-1, 1)[:n_words]
    return draws_from_words(flat).reshape(-1)
