"""The reference-compatible v1 container (a copy of the header and
assembly parts of ``qvz_tpu.format.container``).

Layout (reference: src/codebook.c:474-555, src/qv_stream.c:66-117):

    [0]      1 byte   cluster count
    [1:5]    4 bytes  columns, big-endian uint32
    [5:9]    4 bytes  lines, big-endian uint32 (truncated from u64!)
    then per cluster, the ASCII codebook block (rt.Design.serialized)
    then 128 bytes raw little-endian WELL-1024a state
    then the arithmetic-coded payload (zero-padded to a byte, with an
    extra 0x00 byte when the tag ends on a byte boundary).
"""

from __future__ import annotations

import struct


def write_header(cluster_count: int, columns: int, lines: int) -> bytes:
    # lines is truncated to uint32 exactly like codebook.c:482 (kept for
    # bit parity), but unlike the reference we warn: a >=2^32-line v1
    # container decodes to the wrong line count. QVZ2 stores u64.
    if lines >= 2**32:
        import warnings
        warnings.warn(
            f"v1 container truncates line count {lines} to uint32 "
            f"(reference quirk, codebook.c:482); the file will not decode "
            f"fully — use the QVZ2 sharded container (--shards) instead",
            RuntimeWarning, stacklevel=2)
    return struct.pack(">B", cluster_count) + \
        struct.pack(">I", columns) + struct.pack(">I", lines & 0xFFFFFFFF)


def read_header(data):
    if len(data) < 9:
        raise ValueError("container too short for header")
    # int() so buffer-protocol inputs (np.memmap) don't leak numpy
    # scalars whose fixed width overflows in later arithmetic
    cluster_count = int(data[0])
    columns, lines = struct.unpack(">II", bytes(data[1:9]))
    if cluster_count == 0 or columns == 0:
        raise ValueError("malformed container header")
    return cluster_count, columns, lines


def build_container_raw(blocks: bytes, cluster_count: int, well_state: bytes,
                        payload: bytes, columns: int, lines: int) -> bytes:
    """Assemble a container from already-serialized codebook blocks."""
    out = bytearray()
    out.extend(write_header(cluster_count, columns, lines))
    out.extend(blocks)
    out.extend(well_state)
    out.extend(payload)
    return bytes(out)
