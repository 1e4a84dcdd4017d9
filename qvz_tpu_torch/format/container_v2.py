"""QVZ2 sharded container (framework extension, NOT in the reference);
a copy of ``qvz_tpu.format.container_v2``.

The reference interleaves every line into ONE adaptive arithmetic stream
(src/qv_compressor.c:76-137), which makes coding inherently sequential.
The QVZ2 container splits the read axis into contiguous shards, each
carrying its own adaptive-model bank and arithmetic stream, so shards
encode and decode in parallel (host threads per shard; stats/k-means on
the accelerator). The per-shard WELL-1024a start states are obtained by
GF(2) jump-ahead on the file-level state, so every shard draws the SAME
dither bits it would have drawn inside the single-stream format — the
lossy reconstruction is byte-identical to the v1 container for the same
input and seed; only the entropy-coding packaging differs (each shard's
models restart adaptation, costing a few hundred bytes per shard).

Layout (all integers big-endian):

    [0:4]    magic b"QVZ2"
    [4]      format version (4)
    [5]      cluster count
    [6]      symbol order: 0 = line-major (reference order),
             1 = column-major (default — all cluster ids, then column 0
             of every line, then column 1, ...; each column's adaptive
             models stay L1-resident during coding, which the line-major
             order cannot achieve once clusters*columns*contexts models
             exceed the cache)
    [7]      priming: 0 = every shard's adaptive models start from
             scratch (counts = 1, fully independent shards); 1 = shards
             1..N-1 start from the model-bank state captured after
             shard 0 ("warmup" shard) — encoder and decoder both derive
             that state by processing shard 0, so the prior costs ZERO
             container bytes and removes nearly all of the per-shard
             adaptation-restart rate overhead; decode of shard k then
             requires shard 0 first (a short serial stage)
    [8:12]   columns  u32
    [12:20]  lines    u64  (no uint32 truncation, unlike v1)
    [20:24]  n_shards u32
    then the per-cluster ASCII codebook blocks (identical to v1)
    then 128 bytes raw file-level WELL-1024a state
    then per shard:
        lines    u64
        payload  u64 length
        xxh64    u64 checksum of the payload bytes (seed 0) — integrity
                 extension the reference lacks entirely (a flipped
                 payload byte silently mis-decodes there); verified
                 before decoding each shard
        128-byte WELL-1024a start state (jump-ahead of the file state)
    then the concatenated shard payloads.

A v1 container's first byte is its cluster count (recommended <= 5,
README.md:41); a collision with the 4-byte magic would need 81 clusters
AND columns == 0x565A32xx, so the decoder tries v2 first and falls back
to v1 on parse failure.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MAGIC = b"QVZ2"
VERSION = 4  # v3: per-shard xxh64 checksums; v4: shard priming byte
ORDER_LINE = 0   # reference symbol order: line-major
ORDER_COL = 1    # column-major: per-column model locality (default)
_HEAD = struct.Struct(">4sBBBBIQI")
_SHARD = struct.Struct(">QQQ")


@dataclass
class ShardInfo:
    lines: int
    payload_off: int  # absolute offset into the container
    payload_len: int
    well_state: bytes  # 128 raw bytes, n=0 semantics
    checksum: int = 0  # xxh64(payload, seed=0)


@dataclass
class ContainerV2:
    cluster_count: int
    columns: int
    lines: int
    blocks: bytes  # codebook blocks span (for tables_from_blocks)
    well_state: bytes  # file-level 128-byte state
    shards: list
    order: int = ORDER_COL
    priming: int = 0


def is_v2(data) -> bool:
    # bytes() so buffer-protocol containers (np.memmap of the container
    # file) compare correctly too
    return bytes(data[:4]) == MAGIC


DIR_ENTRY_SIZE = _SHARD.size + 128   # one shard's directory entry


def head(blocks: bytes, cluster_count: int, columns: int, lines: int,
         n_shards: int, file_state: bytes, order: int = ORDER_COL,
         priming: int = 0) -> bytes:
    """The container up to its shard directory: the header, the codebook
    blocks and the file-level WELL state (shard 0's start state)."""
    assert len(file_state) == 128
    return (_HEAD.pack(MAGIC, VERSION, cluster_count, order, priming,
                       columns, lines, n_shards) + blocks + file_state)


def dir_entry(lines: int, payload_len: int, checksum: int,
              state: bytes) -> bytes:
    """One shard's directory entry: lines, payload length, the payload's
    xxh64 and the 128-byte WELL start state."""
    assert len(state) == 128
    return _SHARD.pack(lines, payload_len, checksum) + state


def build(blocks: bytes, cluster_count: int, columns: int, lines: int,
          shard_lines: list, shard_states: list, payloads: list,
          order: int = ORDER_COL, priming: int = 0) -> bytes:
    """Assemble a QVZ2 container.

    shard_lines: lines per shard; shard_states: 128-byte WELL start
    state per shard; payloads: arithmetic payload bytes per shard.
    Per-shard xxh64 payload checksums are computed here.
    """
    from qvz_tpu_torch.native import runtime as _rt

    n_shards = len(payloads)
    assert len(shard_lines) == n_shards and len(shard_states) == n_shards
    out = bytearray(head(blocks, cluster_count, columns, lines, n_shards,
                         shard_states[0], order, priming))
    for nl, st, pay in zip(shard_lines, shard_states, payloads):
        out += dir_entry(nl, len(pay), _rt.xxh64(bytes(pay)), st)
    for pay in payloads:
        out += pay
    return bytes(out)


def parse(data: bytes, blocks_len: int | None = None,
          payload_limit: int | None = None) -> ContainerV2:
    """Parse header + shard directory.

    blocks_len: length of the codebook-blocks span; pass None to have
    the caller locate it via Tables.consumed (parse in two steps: call
    with blocks_len=None to read the fixed header only — blocks/shards
    empty — then again with the measured length).

    payload_limit: validate payload extents against this total size
    instead of len(data) — lets a caller parse the directory from a
    small prefix of a large memory-mapped container (the payload bytes
    live past the prefix but inside the real file). The directory
    itself must still fit in `data`.
    """
    if len(data) < _HEAD.size:
        raise ValueError("truncated QVZ2 container (short header)")
    (magic, version, cc, order, priming, columns, lines,
     n_shards) = _HEAD.unpack(data[:_HEAD.size])
    if magic != MAGIC or version != VERSION:
        raise ValueError("not a QVZ2 container")
    if order not in (ORDER_LINE, ORDER_COL):
        raise ValueError("unknown QVZ2 symbol order")
    if priming not in (0, 1):
        raise ValueError("unknown QVZ2 priming mode")
    head = ContainerV2(cc, columns, lines, b"", b"", [], order, priming)
    if blocks_len is None:
        return head
    pos = _HEAD.size
    # Every slice below is explicitly bounds-checked: the state slices
    # flow into the native Well constructor, which memcpy's 32 words
    # unconditionally — a short slice would be a heap over-read.
    need = pos + blocks_len + 128 + n_shards * (_SHARD.size + 128)
    if len(data) < need:
        raise ValueError("truncated QVZ2 container (short directory)")
    head.blocks = data[pos:pos + blocks_len]
    pos += blocks_len
    head.well_state = data[pos:pos + 128]
    pos += 128
    metas = []
    for _ in range(n_shards):
        nl, plen, ck = _SHARD.unpack(data[pos:pos + _SHARD.size])
        pos += _SHARD.size
        st = data[pos:pos + 128]
        pos += 128
        metas.append((nl, plen, st, ck))
    for nl, plen, st, ck in metas:
        head.shards.append(ShardInfo(nl, pos, plen, st, ck))
        pos += plen
    if pos > (payload_limit if payload_limit is not None else len(data)):
        raise ValueError("truncated QVZ2 container (short payload)")
    if sum(s.lines for s in head.shards) != lines:
        raise ValueError("shard line counts do not sum to total lines")
    return head


def header_size() -> int:
    return _HEAD.size
