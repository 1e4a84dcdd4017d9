"""Lossless container transcoding between v1 and QVZ2 (a copy of
``qvz_tpu.tools.transcode`` over the port's host runtime).

    python -m qvz_tpu_torch.tools.transcode in.q out.q --to v2 [--shards N]
    python -m qvz_tpu_torch.tools.transcode in.q out.q --to v1

No re-quantization happens: the decoded symbol stream (quantizer output
STATES, not values) is re-entropy-coded under the target format's
stream order and model banks, with the SAME codebook blocks and WELL
state carried over. Consequently:

  * transcode(v1 -> QVZ2) is byte-identical to having encoded the
    original raw input directly with the port's --shards (the same shard
    plan, pipeline/host.shard_plan; --shards 0, the default, is the
    device lane count of the port's CLI, not one shard per CPU as in
    qvz_tpu),
  * transcode(QVZ2 -> v1) is byte-identical to the reference-compatible
    v1 container a direct encode would produce — i.e. a QVZ2 archive
    can be converted into a container the reference C binary decodes,
    without access to the original data,

both proven by tests/test_torch_tools.py. (The reference has no analog;
its only format is the single stream, qv_compressor.c:48-143.)
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from qvz_tpu_torch.constants import ALPHABET_SIZE, PHRED_OFFSET
from qvz_tpu_torch.format import container, container_v2
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline.host import shard_plan

A = ALPHABET_SIZE


def _inverse_state_map(tables) -> np.ndarray:
    """(n_models, 72) value -> state index within each model's output
    alphabet (alphabets are sorted-unique, so the map is well defined)."""
    model_off = np.asarray(tables.model_off)
    model_syms = np.asarray(tables.model_syms)
    lens = (model_off[1:] - model_off[:-1]).astype(np.int64)
    inv = np.full((tables.n_models, A), 255, dtype=np.uint8)
    mids = np.repeat(np.arange(tables.n_models), lens)
    pos = (np.arange(len(model_syms), dtype=np.int64)
           - np.repeat(model_off[:-1].astype(np.int64), lens))
    inv[mids, model_syms] = pos.astype(np.uint8)
    return inv


def _requant(tables, qv: np.ndarray, cluster_ids, draws: np.ndarray):
    """Map decoded symbols back to (model id, state index) per symbol.

    Same context/dither chain as quantization (qv_compressor.c:86-118)
    but the input IS the quantized value, so no quantizer map is applied
    — only the model resolution and the inverse output-alphabet lookup.
    Vectorized over lines, sequential over columns."""
    n, cols = qv.shape
    ctxmap = np.asarray(tables.ctxmap)        # (nc*cols, 72)
    pair_base = np.asarray(tables.pair_base).astype(np.int64)
    qratio = np.asarray(tables.qratio)
    inv = _inverse_state_map(tables)
    cl = (np.zeros(n, dtype=np.int64) if cluster_ids is None
          else cluster_ids.astype(np.int64))
    cbase = cl * cols
    prev = np.zeros(n, dtype=np.int64)
    M = np.empty((n, cols), dtype=np.uint32)
    X = np.empty((n, cols), dtype=np.uint8)
    for col in range(cols):
        cc = cbase + col
        ctx = ctxmap[cc, prev].astype(np.int64)
        if (ctx < 0).any():
            raise ValueError("corrupt stream: symbol outside context")
        p = pair_base[cc] + ctx
        choice = (draws[:, col] >= qratio[p]).astype(np.int64)
        m = 1 + p * 2 + choice
        x = inv[m, qv[:, col]]
        if (x == 255).any():
            raise ValueError("corrupt stream: value outside model")
        M[:, col] = m
        X[:, col] = x
        prev = qv[:, col].astype(np.int64)
    return M, X


def _decode_full(comp):
    """Decode any container to (tables, blocks, well_words, qv, cl)."""
    if container_v2.is_v2(comp):
        head = container_v2.parse(comp, blocks_len=None)
        tables = rt.tables_from_blocks(
            bytes(comp[container_v2.header_size():]), head.cluster_count,
            head.columns)
        head = container_v2.parse(comp, blocks_len=tables.consumed)
        cols = head.columns
        qv = np.empty((head.lines, cols), dtype=np.uint8)
        cl = np.empty(head.lines, dtype=np.uint8)
        offs = np.concatenate(
            [[0], np.cumsum([s.lines for s in head.shards])]).astype(int)
        bank = None
        for i, s in enumerate(head.shards):
            payload = bytes(comp[s.payload_off:s.payload_off
                                 + s.payload_len])
            if rt.xxh64(payload) != s.checksum:
                raise ValueError(f"shard {i} checksum mismatch")
            well = np.frombuffer(s.well_state, dtype="<u4")
            want_bank = bool(head.priming) and i == 0 \
                and len(head.shards) > 1
            res = rt.decode_colmajor(
                tables, payload, s.lines, well,
                init_bank=bank if (head.priming and i > 0) else None,
                want_bank=want_bank, cluster_out=True)
            if want_bank:
                out, bank, shard_cl = res
            else:
                out, shard_cl = res
            qv[offs[i]:offs[i + 1]] = out[:, :cols] - PHRED_OFFSET
            cl[offs[i]:offs[i + 1]] = shard_cl
        well_words = np.frombuffer(head.well_state, dtype="<u4")
        return (tables, bytes(head.blocks), well_words, qv, cl,
                head.cluster_count)
    cluster_count, cols, lines = container.read_header(bytes(comp[:9]))
    tables = rt.tables_from_blocks(bytes(comp[9:]), cluster_count, cols)
    pos = 9 + tables.consumed
    well_words = np.frombuffer(bytes(comp[pos:pos + 128]), dtype="<u4")
    payload = bytes(comp[pos + 128:])
    out, cl = rt.decode_lines(tables, payload, lines, well_words,
                              cluster_out=True)
    qv = np.ascontiguousarray(out[:, :cols]) - PHRED_OFFSET
    return tables, bytes(comp[9:9 + tables.consumed]), well_words, qv, \
        cl, cluster_count


def transcode(in_path: str, out_path: str, to: str, *, shards: int = 0,
              prime: bool = True) -> None:
    """Rewrite the container at in_path as `to` ("v1" or "v2") at
    out_path. For "v2": shards as the port's encode takes them (0 the
    device lane count) and priming, as in a direct encode."""
    comp = np.memmap(in_path, dtype=np.uint8, mode="r")
    tables, blocks, well_words, qv, cl, n_clusters = _decode_full(comp)
    n, cols = qv.shape
    cl_arg = cl if n_clusters > 1 else None
    draws = rt.well_draws7(well_words, n * cols).reshape(n, cols)
    M, X = _requant(tables, qv, cl_arg, draws)

    if to == "v1":
        payload = rt.encode_lines(tables, cl_arg, M, X)
        out = container.build_container_raw(
            blocks, n_clusters, np.asarray(well_words,
                                           dtype="<u4").tobytes(),
            payload, cols, n)
        with open(out_path, "wb") as f:
            f.write(out)
        return

    # target QVZ2: the port's encode plan, so the result is byte-identical
    # to a direct encode of the original data at this shard count
    if shards == 0:
        from qvz_tpu_torch.pipeline.encode import device_lane_count
        shards = device_lane_count(n)
    shards = max(1, min(shards, n))
    counts, states, offs, prime_on = shard_plan(
        n, cols, shards, prime, WellState(well_words))

    def code(s, init_bank=None, want_bank=False):
        lo, hi = int(offs[s]), int(offs[s + 1])
        return rt.encode_precomputed_colmajor(
            tables, np.ascontiguousarray(M[lo:hi].T),
            np.ascontiguousarray(X[lo:hi].T),
            cl_arg[lo:hi] if cl_arg is not None else None, hi - lo,
            init_bank=init_bank, want_bank=want_bank)

    if prime_on:
        pay0, bank = code(0, want_bank=True)
        with ThreadPoolExecutor(
                max_workers=min(len(counts) - 1,
                                os.cpu_count() or 1)) as ex:
            payloads = [pay0] + list(ex.map(
                lambda s: code(s, init_bank=bank),
                range(1, len(counts))))
    else:
        with ThreadPoolExecutor(
                max_workers=min(len(counts), os.cpu_count() or 1)) as ex:
            payloads = list(ex.map(code, range(len(counts))))
    shard_states = [np.asarray(states[s], dtype="<u4").tobytes()
                    for s in range(len(counts))]
    out = container_v2.build(blocks, n_clusters, cols, n, counts,
                             shard_states, payloads,
                             priming=1 if prime_on else 0)
    with open(out_path, "wb") as f:
        f.write(out)


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    try:
        args = argv[1:]
        to = None
        shards = 0
        prime = True
        files = []
        i = 0
        while i < len(args):
            if args[i] == "--to":
                to = args[i + 1]
                i += 2
            elif args[i] == "--shards":
                shards = int(args[i + 1])
                i += 2
            elif args[i] == "--no-prime":
                prime = False
                i += 1
            else:
                files.append(args[i])
                i += 1
        if to not in ("v1", "v2") or len(files) != 2:
            raise IndexError
    except (IndexError, ValueError):
        print(__doc__, file=sys.stderr)
        return 1
    try:
        transcode(files[0], files[1], to, shards=shards, prime=prime)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
