"""Multi-host driver: N processes, contiguous read ranges, one container
(counterpart of ``qvz_tpu.parallel.multihost``).

Each host owns a contiguous range of reads (whole shards), computes its
local integer statistics and codes its shards; the coordinator merges the
statistics, designs the codebooks once, sends the serialized blocks out
and writes the shard directory in read order. Every cross-host reduction
is an exact integer sum and every shard payload depends only on the
blocks, the shard's WELL start state and its rows, so the container is
byte-identical to the one-process QVZ2 encode for any host count.

Hosts are worker processes started as fresh interpreters (``subprocess``
and ``-c``, never a fork after CUDA is initialised), connected back over
a ``multiprocessing.connection`` socket on localhost for the small
control-plane messages (centroids, count tensors, codebook blocks,
payloads). With ``device="cuda"`` the coordinator builds the kernel
library before it starts them, and each in-memory worker counts its rows
with K3 (``ops/stats``) on the card; ``device="cpu"`` runs K3's plain
version. Streaming workers and ``decode_multihost`` run on the host, as
in ``qvz_tpu``.

Phases (as pipeline/encode.py):
  1. plan: the shard plan and the shards' WELL jump states (coordinator)
  2. k-means (-c K > 1): each host's assignment and integer accumulators
     a Lloyd iteration, merged by the coordinator (cluster.c:212-243)
  3. statistics: each host's conditional histograms, summed
  4. design: once, on the coordinator, from the summed counts
  5. coding: each host codes its shards (threads inside the host)
  6. assembly: the coordinator builds the QVZ2 container in read order

The environment names ``QVZ_MH_AUTHKEY`` (the socket's key) and
``QVZ_MH_CHAOS`` (failure injection for the clean-failure tests) are
``qvz_tpu``'s.
"""

from __future__ import annotations

import os
import selectors
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing.connection import Client, Listener
from threading import Lock

import numpy as np

from qvz_tpu_torch import _build
from qvz_tpu_torch.constants import (ALPHABET_SIZE, DISTORTION_MSE,
                                     MAX_KMEANS_ITERATIONS, MODE_RATIO,
                                     PHRED_OFFSET)
from qvz_tpu_torch.format import container_v2
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.ops.well import WellState
from qvz_tpu_torch.pipeline.host import (_drop_pages, _geometry, _rows,
                                         _rows_t, shard_plan)
from qvz_tpu_torch.spec import kmeans as spec_kmeans

# torch is imported where a phase needs it (an in-memory worker's K3, the
# coordinator's device check): a decode or streaming worker starts
# without it, which on the card's machine saves seconds a worker.

# ---------------------------------------------------------------------------
# Worker process: owns rows [lo, hi) of the quality file.


def _worker_main(port: int, path: str, lo: int, hi: int, columns: int,
                 device: str, recon_path: str | None = None,
                 chunk_lines: int = 0) -> None:
    """Subprocess entry: connect back to the coordinator and serve."""
    authkey = bytes.fromhex(os.environ["QVZ_MH_AUTHKEY"])
    conn = Client(("127.0.0.1", port), authkey=authkey)
    _host_worker(conn, path, lo, hi, columns, device, recon_path,
                 chunk_lines)


def _host_worker(conn, path: str, lo: int, hi: int, columns: int,
                 device: str, recon_path: str | None = None,
                 chunk_lines: int = 0) -> None:
    """One host. Owns rows [lo, hi); serves phase requests.

    chunk_lines == 0: the row range is loaded once, and its statistics
    run on K3 on `device`. chunk_lines > 0: a streaming worker, which
    never holds its range: k-means and statistics run over chunk_lines
    rows of the memmap at a time on the host, coding takes one shard a
    thread and drops its pages after, and the payloads go to a spill file
    instead of over the control plane."""
    A = ALPHABET_SIZE
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    streaming = chunk_lines > 0
    # Phred+33 text to symbols (codebook.c:200), a host copy of the range
    data = None if streaming else _rows(mm, columns, lo, hi)
    n_local = hi - lo

    def rows_sym(a: int, b: int) -> np.ndarray:
        """Local rows [a, b) as 0-based symbols."""
        if data is not None:
            return data[a:b]
        return _rows(mm, columns, lo + a, lo + b)

    def rows_sym_t(a: int, b: int) -> np.ndarray:
        """Local rows [a, b) column-major (one shard-sized buffer)."""
        if data is not None:
            return np.ascontiguousarray(data[a:b].T)
        return _rows_t(mm, columns, lo + a, lo + b)

    def done_with(a: int, b: int) -> None:
        if streaming:
            _drop_pages(mm, columns, lo + a, lo + b)

    # failure injection (the clean-failure tests): a worker that dies, or
    # ships short payloads
    chaos = os.environ.get("QVZ_MH_CHAOS", "")

    assign = None
    # -u: each host writes its reconstruction rows straight into the
    # text file the coordinator sized
    recon_mm = None
    if recon_path is not None:
        recon_mm = np.memmap(recon_path, dtype=np.uint8,
                             mode="r+").reshape(-1, columns + 1)

    def put_recon(row0: int, recon: np.ndarray) -> None:
        dst = recon_mm[lo + row0: lo + row0 + len(recon)]
        dst[:, :columns] = recon + PHRED_OFFSET
        dst[:, columns] = ord("\n")

    while True:
        msg = conn.recv()
        cmd = msg[0]
        if cmd == "rows":
            # centroid seeds: specific global rows this host owns
            conn.send(np.stack([rows_sym(g - lo, g - lo + 1)[0]
                                for g in msg[1]]))
        elif cmd == "kmeans_iter":
            means = msg[1]
            if assign is None:
                assign = np.empty(n_local, dtype=np.uint8)
            if streaming:
                sums = np.zeros_like(means)
                counts = np.zeros(len(means), dtype=np.int64)
                for a in range(0, n_local, chunk_lines):
                    b = min(n_local, a + chunk_lines)
                    asg, s_, c_ = rt.kmeans_iter(rows_sym(a, b), means)
                    assign[a:b] = asg
                    sums += s_
                    counts += c_
            else:
                assign, sums, counts = rt.kmeans_iter(data, means)
            conn.send((sums, counts))
        elif cmd == "stats":
            n_clusters = msg[1]
            cl = assign if n_clusters > 1 else None
            if streaming:
                c0 = np.zeros((n_clusters, A), dtype=np.uint64)
                cond = np.zeros((n_clusters, columns - 1, A, A),
                                dtype=np.uint64)
                for a in range(0, n_local, chunk_lines):
                    b = min(n_local, a + chunk_lines)
                    rt.stats_host(rows_sym(a, b),
                                  cl[a:b] if cl is not None else None,
                                  n_clusters, accumulate=(c0, cond))
                    if n_clusters == 1:
                        # nothing reads this range again before its own
                        # shard codes it
                        done_with(a, b)
            else:
                import torch

                from qvz_tpu_torch.ops import stats as dev_stats
                dev = torch.device(device)
                c0, cond = dev_stats.conditional_counts(
                    torch.from_numpy(data).to(dev),
                    torch.from_numpy(cl).to(dev) if cl is not None
                    else None, n_clusters)
                c0, cond = c0.cpu().numpy(), cond.cpu().numpy()
            conn.send((c0, cond, _build.LAUNCHES["hist"]))
        elif cmd == "encode_warmup":
            # the priming source: code only the warmup shard (this host's
            # first) and return its payload and the bank snapshot
            blocks, n_clusters, state0, count0, dist = msg[1:]
            tables = rt.tables_from_blocks(blocks, n_clusters, columns)
            pay, recon, dsum, bank = rt.encode_fused_colmajor(
                tables, rows_sym_t(0, count0),
                assign[:count0] if assign is not None else None,
                state0, dist=dist, want_recon=recon_mm is not None,
                want_bank=True)
            if recon is not None:
                put_recon(0, recon)
            conn.send((pay, dsum, bank))
        elif cmd == "encode":
            if chaos == "die_on_encode" and lo > 0:
                os._exit(17)            # a worker death in mid-phase
            (blocks, n_clusters, states, counts, dist, skip0, bank,
             spill_path) = msg[1:]
            tables = rt.tables_from_blocks(blocks, n_clusters, columns)
            offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            S_loc = len(counts)
            # streaming: payloads land in the spill file in shard order
            # (out-of-order completions wait their turn, bounded by the
            # thread count), so the coordinator copies them straight in
            spill_f = open(spill_path, "wb") if spill_path else None
            meta = [None] * S_loc
            pending = {}
            nxt = [skip0]
            wlock = Lock()

            def emit(s, pay, dsum):
                meta[s] = (len(pay), rt.xxh64(pay), float(dsum))
                pending[s] = pay
                if spill_f is None:
                    return
                while nxt[0] in pending:
                    spill_f.write(pending.pop(nxt[0]))
                    nxt[0] += 1

            def run(s):
                a, b = int(offs[s]), int(offs[s + 1])
                pay, recon, dsum = rt.encode_fused_colmajor(
                    tables, rows_sym_t(a, b),
                    assign[a:b] if assign is not None else None,
                    states[s], dist=dist,
                    want_recon=recon_mm is not None,
                    init_bank=bank)
                if recon is not None:
                    put_recon(a, recon)
                done_with(a, b)
                with wlock:
                    emit(s, pay, dsum)

            todo = range(skip0, S_loc)
            with ThreadPoolExecutor(
                    max_workers=max(1, min(S_loc - skip0,
                                           os.cpu_count() or 1))) as ex:
                list(ex.map(run, todo))
            if recon_mm is not None:
                recon_mm.base.flush()
            dsum_total = float(sum(m[2] for m in meta[skip0:]))
            if spill_f is not None:
                spill_f.close()
                if chaos == "truncate_spill" and lo > 0:
                    # a short payload: the directory entries still claim
                    # the full size
                    with open(spill_path, "r+b") as tf:
                        tf.truncate(max(0,
                                        os.path.getsize(spill_path) - 64))
                conn.send(([(m[0], m[1]) for m in meta[skip0:]],
                           dsum_total))
            else:
                conn.send(([pending[s] for s in todo], dsum_total))
        elif cmd == "quit":
            conn.send(("bye",))
            return


def _decode_worker_main(port: int, container_path: str, out_path: str
                        ) -> None:
    """Subprocess entry of the distributed decode: decode one batch of
    shards on the host, writing the text into the sized output file."""
    authkey = bytes.fromhex(os.environ["QVZ_MH_AUTHKEY"])
    conn = Client(("127.0.0.1", port), authkey=authkey)
    comp = np.memmap(container_path, dtype=np.uint8, mode="r")
    while True:
        msg = conn.recv()
        if msg[0] == "decode":
            (blocks, n_clusters, columns, order, metas, line_offs,
             bank) = msg[1:]
            tables = rt.tables_from_blocks(blocks, n_clusters, columns)
            fd = os.open(out_path, os.O_WRONLY)

            def run(i):
                off, plen, nl, well, ck = metas[i]
                payload = bytes(comp[off:off + plen])
                if rt.xxh64(payload) != ck:
                    raise ValueError(f"shard checksum mismatch at {off}")
                # line-major shards never carry a primed bank (the
                # coordinator refuses priming with ORDER_LINE)
                if order == container_v2.ORDER_COL:
                    out = rt.decode_colmajor(
                        tables, payload, nl,
                        np.frombuffer(well, dtype="<u4"), init_bank=bank)
                else:
                    out = rt.decode_lines(
                        tables, payload, nl,
                        np.frombuffer(well, dtype="<u4"))
                os.pwrite(fd, out.tobytes(), line_offs[i] * (columns + 1))
                return nl

            try:
                with ThreadPoolExecutor(
                        max_workers=min(len(metas),
                                        os.cpu_count() or 1)) as ex:
                    done = list(ex.map(run, range(len(metas))))
                conn.send(("ok", int(sum(done))))
            finally:
                os.close(fd)
        elif msg[0] == "quit":
            conn.send(("bye",))
            return


# ---------------------------------------------------------------------------
# Coordinator.


def _accept_checked(listener, proc, timeout: float = 120.0):
    """listener.accept() that fails fast instead of hanging when the
    worker just started dies before it connects (an import failure, OOM,
    a bad PYTHONPATH): waits for the socket in 1 s slices and checks the
    process in between."""
    sock = listener._listener._socket
    deadline = time.monotonic() + timeout
    with selectors.DefaultSelector() as sel:
        sel.register(sock, selectors.EVENT_READ)
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"multihost worker exited with code {proc.returncode} "
                    "before connecting back")
            if sel.select(timeout=1.0):
                return listener.accept()
            if time.monotonic() > deadline:
                proc.kill()
                raise RuntimeError(
                    "timed out waiting for multihost worker to connect")


def _recv_checked(conn, proc, host: int, phase: str):
    """conn.recv() that turns a dead or wedged worker into an error that
    names it and the phase: polls in 1 s slices and checks the process in
    between; a worker that exited gets one 0.5 s poll to drain a message
    it sent just before."""
    while True:
        if conn.poll(1.0):
            try:
                return conn.recv()
            except (EOFError, OSError):
                raise RuntimeError(
                    f"multihost worker {host} closed its control pipe "
                    f"during {phase} (exit code {proc.poll()}); no "
                    "container was written") from None
        rc = proc.poll()
        if rc is not None:
            if conn.poll(0.5):
                try:
                    return conn.recv()
                except (EOFError, OSError):
                    pass
            raise RuntimeError(
                f"multihost worker {host} died during {phase} with exit "
                f"code {rc}; no container was written")


def _launch():
    """A listener on localhost and the environment of its workers: the
    socket's key and this checkout first on PYTHONPATH. Returns
    (listener, port, env)."""
    authkey = os.urandom(16)
    listener = Listener(("127.0.0.1", 0), authkey=authkey)
    env = dict(os.environ)
    env["QVZ_MH_AUTHKEY"] = authkey.hex()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return listener, listener.address[1], env


def encode_multihost(path: str, *, n_hosts: int, shards: int = 0,
                     n_clusters: int = 1, mode: int = MODE_RATIO,
                     ratio: float = 0.5, cluster_threshold: float = 4.0,
                     well_state=None, dist_matrix=None,
                     device: str = "cuda", prime: bool = True,
                     recon_path: str | None = None,
                     verbose: bool = False,
                     streaming: bool = False,
                     chunk_lines: int = 1_000_000,
                     output_path: str | None = None):
    """Encode a quality file across n_hosts worker processes.

    Returns (container bytes, stats dict). The container is
    byte-identical to the one-process QVZ2 encode for the same total
    shard count. The stats dict is qvz_tpu's (hosts, shards, lines,
    columns, kmeans_iters at -c K, cluster_s, stats_s, design_s, code_s,
    total_s, payload_bytes, rate, distortion) and worker_launches, each
    worker's K3 launches in host order ({"hist": [k_0, k_1, ...]}).

    streaming=True (needs output_path): workers stream their row ranges
    in chunk_lines passes instead of holding them, shard payloads spill
    to files beside output_path, and the coordinator writes the
    container straight to output_path (returns (None, stats)).
    """
    from qvz_tpu_torch.device import resolve

    dev = resolve(device)
    if dev.type == "cuda" and not streaming:
        # one build before the workers start, not one nvcc run each
        _build.load()
    if well_state is None:
        well_state = WellState.debug()
    if dist_matrix is None:
        dist_matrix = make_matrix(DISTORTION_MSE)
    if streaming and output_path is None:
        raise ValueError("streaming multihost encode needs output_path")

    n, columns = _geometry(path)
    if shards == 0:
        shards = max(n_hosts, (os.cpu_count() or 1))
        if streaming:
            # bounded-memory coding needs bounded shards (each worker
            # thread holds one; 1M lines as encode_streaming's
            # max_shard_lines)
            shards = max(shards, -(-n // 1_000_000))
    counts, states, offs, prime_on = shard_plan(n, columns, shards, prime,
                                                well_state)
    S = len(counts)
    n_hosts = max(1, min(n_hosts, S))
    # contiguous shard ranges per host
    host_shards = [(h * S // n_hosts, (h + 1) * S // n_hosts)
                   for h in range(n_hosts)]
    t0 = time.perf_counter()

    listener, port, env = _launch()
    if recon_path is not None:
        # size the -u file so that workers can map it r+ and write their
        # row ranges in place
        np.memmap(recon_path, dtype=np.uint8, mode="w+",
                  shape=(n, columns + 1)).flush()
    ck_lines = chunk_lines if streaming else 0
    conns, procs = [], []
    stats = {"hosts": n_hosts, "shards": S, "lines": n, "columns": columns}
    sdir = None
    try:
        for s0, s1 in host_shards:
            code = ("from qvz_tpu_torch.parallel.multihost import "
                    f"_worker_main; _worker_main({port}, {path!r}, "
                    f"{int(offs[s0])}, {int(offs[s1])}, {columns}, "
                    f"{str(dev)!r}, {recon_path!r}, {ck_lines})")
            procs.append(subprocess.Popen([sys.executable, "-c", code],
                                          env=env))
            conns.append(_accept_checked(listener, procs[-1]))

        # --- k-means (integer accumulators merged here) -----------------
        if n_clusters > 1:
            # the reference's seeds (cluster.c:192-206), fetched from
            # the hosts that own them
            means = np.empty((n_clusters, columns), dtype=np.int64)
            for j, gidx in enumerate(spec_kmeans.seed_rows(
                    n, n_clusters, verbose=verbose)):
                h = next(i for i, (s0, s1) in enumerate(host_shards)
                         if offs[s0] <= gidx < offs[s1])
                conns[h].send(("rows", [gidx]))
                means[j] = _recv_checked(conns[h], procs[h], h,
                                         "k-means seeding")[0]
            iters = 0
            while iters < MAX_KMEANS_ITERATIONS:
                for c in conns:
                    c.send(("kmeans_iter", means))
                sums = np.zeros((n_clusters, columns), dtype=np.int64)
                cnts = np.zeros(n_clusters, dtype=np.int64)
                for hh, c in enumerate(conns):
                    s_, c_ = _recv_checked(c, procs[hh], hh,
                                           "k-means iteration")
                    sums += s_
                    cnts += c_
                iters += 1
                means, stop = spec_kmeans.update_means(
                    means, sums, cnts, cluster_threshold, verbose)
                if stop:
                    break
            if verbose:
                spec_kmeans.verbose_total(iters)
            stats["kmeans_iters"] = iters
        t1 = time.perf_counter()
        stats["cluster_s"] = t1 - t0

        # --- statistics (summed across hosts) ---------------------------
        for c in conns:
            c.send(("stats", n_clusters))
        c0_sum = cond_sum = None
        launches = []
        for hh, c in enumerate(conns):
            c0, cond, k3 = _recv_checked(c, procs[hh], hh, "statistics")
            launches.append(k3)
            if c0_sum is None:
                c0_sum, cond_sum = c0.copy(), cond.copy()
            else:
                c0_sum += c0
                cond_sum += cond
        stats["worker_launches"] = {"hist": launches}
        t2 = time.perf_counter()
        stats["stats_s"] = t2 - t1

        # --- design (once, here) ----------------------------------------
        design = rt.Design(np.asarray(c0_sum), np.asarray(cond_sum),
                           mode, ratio, dist_matrix)
        blocks = design.serialized()
        t3 = time.perf_counter()
        stats["design_s"] = t3 - t2

        # --- coding (each host codes its shards) ------------------------
        # With priming, host 0 codes the warmup shard alone first and its
        # bank snapshot goes to every host.
        dist_total = 0.0
        warm_pay = None
        bank = None
        if prime_on:
            conns[0].send(("encode_warmup", blocks, n_clusters,
                           states[0], int(counts[0]), dist_matrix))
            warm_pay, dsum0, bank = _recv_checked(
                conns[0], procs[0], 0, "warmup encode")
            dist_total += dsum0
        spills = [None] * n_hosts
        if streaming:
            sdir = tempfile.mkdtemp(prefix="qvz_mh_spill_",
                                    dir=os.path.dirname(
                                        os.path.abspath(output_path)))
            spills = [os.path.join(sdir, f"host{h}.pay")
                      for h in range(n_hosts)]
        payload_lists = [None] * n_hosts
        for h, (s0, s1) in enumerate(host_shards):
            skip0 = 1 if (prime_on and h == 0) else 0
            conns[h].send(("encode", blocks, n_clusters,
                           states[s0:s1], counts[s0:s1], dist_matrix,
                           skip0, bank, spills[h]))
        for h, c in enumerate(conns):
            payloads, dsum = _recv_checked(c, procs[h], h, "coding")
            payload_lists[h] = payloads
            dist_total += dsum
        t4 = time.perf_counter()
        stats["code_s"] = t4 - t3

        if streaming:
            metas = []
            if prime_on:
                metas.append((len(warm_pay), rt.xxh64(warm_pay)))
            for lst in payload_lists:
                metas.extend(lst)
            assert len(metas) == S
            # fail clean before the container exists: every spill file
            # must hold exactly the bytes its host's directory entries
            # claim
            for h, lst in enumerate(payload_lists):
                want = sum(m[0] for m in lst)
                got = os.path.getsize(spills[h])
                if got != want:
                    raise ValueError(
                        f"multihost worker {h} spill file holds {got} "
                        f"payload bytes but its shard directory entries "
                        f"claim {want} — truncated/corrupt payload; no "
                        "container was written")
            _write_streamed(output_path, blocks, n_clusters, columns, n,
                            counts, states, metas, prime_on, warm_pay,
                            spills)
            os.rmdir(sdir)
            compressed = None
            payload_bytes = sum(m[0] for m in metas)
        else:
            if prime_on:
                payload_lists[0] = [warm_pay] + payload_lists[0]
            all_payloads = [p for lst in payload_lists for p in lst]
            shard_states = [np.asarray(states[s], dtype="<u4").tobytes()
                            for s in range(S)]
            compressed = container_v2.build(
                blocks, n_clusters, columns, n, counts, shard_states,
                all_payloads, priming=1 if prime_on else 0)
            payload_bytes = sum(len(p) for p in all_payloads)
        stats["payload_bytes"] = payload_bytes
        stats["rate"] = payload_bytes * 8.0 / (float(n) * columns)
        stats["distortion"] = dist_total / n
        stats["total_s"] = time.perf_counter() - t0
        return compressed, stats
    finally:
        if sdir is not None and os.path.isdir(sdir):
            shutil.rmtree(sdir, ignore_errors=True)
        _stop(conns, procs, listener)


def _write_streamed(output_path, blocks, n_clusters, columns, n, counts,
                    states, metas, prime_on, warm_pay, spills):
    """Write the container straight to output_path: header, blocks, file
    state, the directory, the warmup payload and each host's spill file,
    byte-identical to container_v2.build. A failure leaves no partial
    container."""
    state_bytes = [np.asarray(st, dtype="<u4").tobytes() for st in states]
    try:
        with open(output_path, "wb") as out_f:
            out_f.write(container_v2.head(
                blocks, n_clusters, columns, n, len(counts), state_bytes[0],
                priming=1 if prime_on else 0))
            for s, (plen, ck) in enumerate(metas):
                out_f.write(container_v2.dir_entry(int(counts[s]), plen, ck,
                                                   state_bytes[s]))
            if prime_on:
                out_f.write(warm_pay)
            for spill in spills:
                with open(spill, "rb") as sf:
                    shutil.copyfileobj(sf, out_f, 16 * 2 ** 20)
                os.unlink(spill)
    except BaseException:
        try:
            os.unlink(output_path)
        except OSError:
            pass
        raise


def _stop(conns, procs, listener) -> None:
    """Ask every worker to quit, close the listener and reap them."""
    for c in conns:
        try:
            c.send(("quit",))
            if c.poll(10):
                c.recv()
        except Exception:
            pass
    listener.close()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def decode_multihost(container_path: str, out_path: str, *,
                     n_hosts: int) -> int:
    """Distributed decode on the host: N worker processes decode
    contiguous shard ranges of a QVZ2 container, each writing its slice
    of the output file. Byte-identical to the one-process decode.
    Returns the line count. With priming, the coordinator decodes the
    warmup shard first and sends its bank to every worker."""
    comp = np.memmap(container_path, dtype=np.uint8, mode="r")
    head_bytes = bytes(comp[:1 << 20]) if comp.size > (1 << 20) else \
        bytes(comp)
    if not container_v2.is_v2(head_bytes):
        raise ValueError("decode_multihost requires a QVZ2 container")
    head = container_v2.parse(head_bytes, blocks_len=None)
    tables = rt.tables_from_blocks(
        head_bytes[container_v2.header_size():], head.cluster_count,
        head.columns)
    # the directory fits the first MB for any sane shard count; payload
    # extents are checked against the real file size
    try:
        head = container_v2.parse(head_bytes, blocks_len=tables.consumed,
                                  payload_limit=comp.size)
    except ValueError:
        head = container_v2.parse(bytes(comp), blocks_len=tables.consumed)
    cols = head.columns
    n = head.lines
    if head.priming and head.order != container_v2.ORDER_COL:
        raise ValueError("primed QVZ2 requires column-major order")

    with open(out_path, "wb") as f:
        f.truncate(n * (cols + 1))

    line_offs = np.concatenate(
        [[0], np.cumsum([s.lines for s in head.shards])]).astype(np.int64)
    blocks = bytes(head.blocks)

    bank = None
    first = 0
    if head.priming and len(head.shards) > 1:
        s0 = head.shards[0]
        payload = bytes(comp[s0.payload_off:s0.payload_off
                             + s0.payload_len])
        if rt.xxh64(payload) != s0.checksum:
            raise ValueError("warmup shard checksum mismatch")
        out0, bank = rt.decode_colmajor(
            tables, payload, s0.lines,
            np.frombuffer(s0.well_state, dtype="<u4"), want_bank=True)
        with open(out_path, "r+b") as f:
            f.write(out0.tobytes())
        first = 1

    todo = list(range(first, len(head.shards)))
    n_hosts = max(1, min(n_hosts, len(todo) or 1))
    if todo:
        listener, port, env = _launch()
        conns, procs = [], []
        ranges = [todo[h * len(todo) // n_hosts:
                       (h + 1) * len(todo) // n_hosts]
                  for h in range(n_hosts)]
        try:
            for _ in range(n_hosts):
                code = ("from qvz_tpu_torch.parallel.multihost import "
                        "_decode_worker_main; _decode_worker_main("
                        f"{port}, {container_path!r}, {out_path!r})")
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], env=env))
                conns.append(_accept_checked(listener, procs[-1]))
            for h, idxs in enumerate(ranges):
                metas = [(head.shards[i].payload_off,
                          head.shards[i].payload_len,
                          head.shards[i].lines,
                          head.shards[i].well_state,
                          head.shards[i].checksum) for i in idxs]
                conns[h].send(("decode", blocks, head.cluster_count,
                               cols, head.order, metas,
                               [int(line_offs[i]) for i in idxs], bank))
            for h, c in enumerate(conns):
                status, _ = _recv_checked(c, procs[h], h, "decode")
                if status != "ok":
                    raise RuntimeError(f"multihost decode worker {h} "
                                       f"answered {status!r}")
        finally:
            _stop(conns, procs, listener)
    return n
