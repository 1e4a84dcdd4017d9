"""The yardstick of the rooflines: the card's peaks and the least work
of a layer, counted from the shapes of what it codes, never from the
program's compiled code.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM3 at 3.35 TB/s; 132 SMs, each retiring 64 32-bit integer operations
a clock at the 1,980 MHz boost clock, 16.73 T integer operations/s.

Operations of one symbol of the m = 22 adaptive arithmetic step
(arith.c:36-96 and qv_stream.c:9-25), each counted as one operation and
the data-dependent parts at their least, so the count bounds the work
from below:

    range = u - l + 1                                  2
    cum_hi = cum_lo + count[x]  (cum_lo's scan: 0)     1
    range * cum_hi, range * cum_lo                     2
    the two divisions by the total                     2
    u = l + . - 1, l = l + .                           3
    renormalisation: l ^ u, its leading bit, the E3 test   4
    update: count[x] += 8, total += 8, total > 2^19    3
                                                      --
    encode                                            17

Bytes: each input read once and each output written once. The coder
(K2s, K2a, K2b) reads a 16-bit model id and an 8-bit symbol per coded
symbol and an 8-bit cluster id per read, and writes the payload bytes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9
ENCODE_OPS_PER_SYMBOL = 17

CODER_KERNELS = ("segment_kernel", "triples_kernel", "chain_kernel")


def coder_least_s(lines: int, columns: int, payload_bytes: int) -> float:
    """The least seconds the card needs to code one file."""
    symbols = lines * columns
    nbytes = symbols * 3 + lines + payload_bytes
    ops = (symbols + lines) * ENCODE_OPS_PER_SYMBOL
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)
