"""The WELL-1024a state of an encode (a copy of the state part of
``qvz_tpu.ops.well``).

The encoder dithers between two quantizers per symbol using 7-bit draws from
a WELL-1024a stream whose raw 128-byte state is serialized in the bitstream
(reference: src/well.c, src/qv_stream.c:70-93). The draws themselves and
the jump-ahead to each shard's start come from the C++ runtime
(``rt.well_draws7``, ``rt.well_jump``); this class carries the state.
"""

from __future__ import annotations

import numpy as np

from qvz_tpu_torch.constants import WELL_DEBUG_WORD

_M32 = 0xFFFFFFFF


class WellState:
    """A WELL-1024a state: 32 words and the rotating index n."""

    __slots__ = ("state", "n")

    def __init__(self, state_words, n: int = 0):
        self.state = [int(w) & _M32 for w in state_words]
        if len(self.state) != 32:
            raise ValueError("a WELL-1024a state is 32 words")
        self.n = n

    @classmethod
    def debug(cls) -> "WellState":
        """State produced by the reference's `make debug` build."""
        return cls([WELL_DEBUG_WORD] * 32)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "WellState":
        """Parse the 128-byte little-endian state stored in the bitstream."""
        if len(raw) != 128:
            raise ValueError("a WELL-1024a state is 128 bytes")
        return cls(np.frombuffer(raw, dtype="<u4").tolist())

    def to_bytes(self) -> bytes:
        return np.asarray(self.state, dtype="<u4").tobytes()
