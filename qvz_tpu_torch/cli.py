"""Command-line interface of the port, flag-compatible with reference qvz
and with ``python -m qvz_tpu``.

Usage: python -m qvz_tpu_torch (options) [input file] [output file]

Flags as ``python -m qvz_tpu`` (src/main.c:166-184): -q/-x/-f/-r/-d/-D/
-c/-T/-u/-h/-s/-v, --debug-seed, --well-state F, --shards N (0, the
default, picks the device lane count; N >= 2 pins it), --no-prime,
--reuse-books F, --profile D, --hosts N and --streaming, plus
--device cuda|cpu (default cuda), which takes the place of --jax and
goes to every branch.
-c K > 1 clusters the reads with k-means on the device first.
--shards 1 codes the reference-compatible v1 container on the host engine
after the device statistics.
--streaming runs the bounded-memory encode (pipeline/streaming.py): the
statistics chunk by chunk on K3, the quantization shard by shard on K1,
the coding on host threads, the container written as it goes. An input
of QVZ_TPU_STREAM_MIN_BYTES (default 1 GiB) or more streams without the
flag unless --shards 1, -u or --reuse-books is given, as in qvz_tpu;
since the port's --shards defaults to 0 (QVZ2), a default encode of a
file of 1 GiB or more streams, where qvz_tpu's default (--shards 1, v1)
does not.
--hosts N encodes across N worker processes (parallel/multihost.py;
streaming workers with --streaming or at the size threshold) and, with
-x, decodes a QVZ2 container across N worker processes on the host.
-x decodes a column-major QVZ2 container's lanes on --device (the lane
decoder K5, as ``python -m qvz_tpu -x --jax`` decodes them on the TPU);
v1 and other containers without lanes decode on the port's host decoder.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from qvz_tpu_torch.constants import (DISTORTION_CUSTOM, DISTORTION_LORENTZ,
                                     DISTORTION_MANHATTAN, DISTORTION_MSE,
                                     MODE_FIXED, MODE_RATIO)
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.ops.well import WellState

def _make_well(opts) -> WellState:
    """The WELL start state of the CLI's options (the helper of
    ``qvz_tpu.cli``): --well-state F, --debug-seed, or os.urandom."""
    if opts.get("well_state_file"):
        with open(opts["well_state_file"], "rb") as f:
            return WellState.from_bytes(f.read(128))
    if opts.get("debug_seed"):
        return WellState.debug()
    return WellState(np.frombuffer(os.urandom(128), dtype="<u4").tolist())


def usage(name: str) -> None:
    print(f"Usage: {name} (options) [input file] [output file]")
    print("Options are:")
    print("   -q           : Store quality values in compressed file (default)")
    print("   -x           : Extract quality values from compressed file")
    print("   -f [ratio]   : Compress using [ratio] bits per bit of input entropy per symbol")
    print("   -r [rate]    : Compress using fixed [rate] bits per symbol")
    print("   -d [M|L|A]   : Optimize for MSE, Log(1+L1), L1 distortions, respectively (default: MSE)")
    print("   -D [FILE]    : Optimize using the custom distortion matrix specified in FILE")
    print("   -c [#]       : Compress using [#] clusters (default: 1)")
    print("   -T [#]       : Use [#] as a threshold for cluster center movement (default: 4)")
    print("   -u [FILE]    : Write the uncompressed lossy values to FILE (default: off)")
    print("   -h           : Print this help")
    print("   -s           : Print summary stats")
    print("   -v           : Enable verbose output")
    print("   --debug-seed : Use the fixed WELL seed (reproducible bitstreams)")
    print("   --well-state F : Load a raw 128-byte WELL state from F")
    print("   --shards N   : QVZ2 container with N parallel streams (0 = pick")
    print("                  for the device, the default; N >= 2 pins it;")
    print("                  1 = the reference-compatible v1 container)")
    print("   --no-prime   : Disable QVZ2 shard priming")
    print("   --reuse-books F : Reuse the codebooks of a previous compressed file F")
    print("                  (skips the statistics + design phases)")
    print("   --profile D  : Write the phase timings to D/phases.json")
    print("   --hosts N    : Encode (or decode a QVZ2 container) across N worker")
    print("                  processes; output byte-identical to --hosts 1")
    print("   --streaming  : Bounded-memory encode (chunked stats, per-shard")
    print("                  quantize, streamed container writes; auto at")
    print("                  QVZ_TPU_STREAM_MIN_BYTES, default 1 GiB)")
    print("   --device D   : cuda (default) or cpu (the kernels' plain versions);")
    print("                  with -x, where QVZ2 shards decode as lanes")


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    name = argv[0] if argv else "qvz_tpu_torch"
    opts = {
        "verbose": False, "stats": False, "ratio": 0.5, "clusters": 1,
        "uncompressed": None, "distortion": DISTORTION_MSE,
        "mode": MODE_RATIO, "cluster_threshold": 4.0, "dist_file": None,
        "debug_seed": False, "well_state_file": None, "shards": 0,
        "prime": True, "device": "cuda", "reuse_books": None,
        "profile_dir": None, "hosts": 1, "streaming": False,
    }
    extract = False
    files = []
    try:
        i = 1
        while i < len(argv):
            a = argv[i]
            if not a.startswith("-"):
                files.append(a)
                i += 1
                continue
            i += 1
            if a == "-x":
                extract = True
            elif a == "-q":
                extract = False
            elif a in ("-f", "-r"):
                opts["ratio"] = float(argv[i])
                opts["mode"] = MODE_RATIO if a == "-f" else MODE_FIXED
                i += 1
            elif a == "-c":
                opts["clusters"] = int(argv[i])
                i += 1
            elif a == "-T":
                opts["cluster_threshold"] = float(int(argv[i]))
                i += 1
            elif a == "-v":
                opts["verbose"] = True
            elif a == "-s":
                opts["stats"] = True
            elif a == "-u":
                opts["uncompressed"] = argv[i]
                i += 1
            elif a == "-d":
                sel = {"M": DISTORTION_MSE, "L": DISTORTION_LORENTZ,
                       "A": DISTORTION_MANHATTAN}.get(argv[i][:1])
                if sel is None:
                    print("Distortion measure not supported, using MSE.")
                opts["distortion"] = sel or DISTORTION_MSE
                i += 1
            elif a == "-D":
                opts["distortion"] = DISTORTION_CUSTOM
                opts["dist_file"] = argv[i]
                i += 1
            elif a == "--debug-seed":
                opts["debug_seed"] = True
            elif a == "--well-state":
                opts["well_state_file"] = argv[i]
                i += 1
            elif a == "--shards":
                opts["shards"] = int(argv[i])
                i += 1
            elif a == "--no-prime":
                opts["prime"] = False
            elif a == "--device":
                opts["device"] = argv[i]
                i += 1
            elif a == "--reuse-books":
                opts["reuse_books"] = argv[i]
                i += 1
            elif a == "--profile":
                opts["profile_dir"] = argv[i]
                i += 1
            elif a == "--hosts":
                opts["hosts"] = int(argv[i])
                i += 1
            elif a == "--streaming":
                opts["streaming"] = True
            elif a == "-h":
                usage(name)
                return 0
            else:
                print(f"Unrecognized option {a}.")
                usage(name)
                return 1
    except (ValueError, IndexError) as e:
        print("Missing value for option." if isinstance(e, IndexError)
              else f"Bad option value: {e}")
        usage(name)
        return 1

    if len(files) != 2:
        print("Missing required filenames.")
        usage(name)
        return 1
    if opts["verbose"]:
        _preamble(opts, extract, *files)
    try:
        return _run(opts, extract, *files)
    except FileNotFoundError as e:
        print(f"Cannot open file: {e.filename}")
        return 1
    except ValueError as e:
        print(f"Error: {e}")
        return 1


def _preamble(opts, extract, input_name, output_name) -> None:
    """The reference's -v preamble (main.c:311-340), worded as
    ``python -m qvz_tpu`` prints it."""
    if extract:
        print(f"{input_name} will be decoded to {output_name}.")
        return
    print(f"{input_name} will be encoded as {output_name}.")
    if opts["mode"] == MODE_RATIO:
        print(f"Ratio mode selected, targeting {opts['ratio']:f} "
              "compression ratio.")
    else:
        print(f"Fixed-rate mode selected, targeting {opts['ratio']:f} "
              "bits per symbol.")
    print({DISTORTION_MSE: "MSE will be used as a distortion metric.",
           DISTORTION_LORENTZ: "log(1+L1) will be used as a distortion "
                               "metric.",
           DISTORTION_MANHATTAN: "L1 will be used as a distortion metric.",
           DISTORTION_CUSTOM: f"A custom distortion metric stored in "
                              f"{opts['dist_file']} will be used."}
          [opts["distortion"]])
    print(f"Compression will use {opts['clusters']} clusters, with a "
          f"movement threshold of {opts['cluster_threshold']:.0f}.")


def _run(opts, extract, input_name, output_name) -> int:
    t0 = time.perf_counter()
    if extract:
        return _extract(opts, input_name, output_name, t0)

    dist = make_matrix(opts["distortion"], path=opts["dist_file"])
    stream_min = int(os.environ.get("QVZ_TPU_STREAM_MIN_BYTES", 2**30))
    # Auto-streaming as in qvz_tpu: never with --reuse-books or -u (those
    # encode in memory instead), never at --shards 1 (the v1 container,
    # which streaming cannot write).
    auto_stream = (not opts["streaming"]
                   and os.path.getsize(input_name) >= stream_min
                   and opts["shards"] != 1
                   and not opts["reuse_books"]
                   and not opts["uncompressed"])
    streaming = opts["streaming"] or auto_stream
    common = dict(n_clusters=opts["clusters"], mode=opts["mode"],
                  ratio=opts["ratio"],
                  cluster_threshold=opts["cluster_threshold"],
                  well_state=_make_well(opts), dist_matrix=dist,
                  shards=opts["shards"] if opts["shards"] != 1 else 0,
                  prime=opts["prime"], recon_path=opts["uncompressed"],
                  device=opts["device"], verbose=opts["verbose"])
    if streaming and opts["hosts"] == 1:
        if opts["reuse_books"]:
            raise ValueError("--streaming does not support --reuse-books")
        from qvz_tpu_torch.pipeline.streaming import encode_streaming
        st = encode_streaming(input_name, output_name, **common)
        elapsed = time.perf_counter() - t0
        if opts["verbose"]:
            print(f"Streaming encode: {st['shards']} shards, "
                  f"{st['lines']} lines.")
            for k in ("cluster_s", "stats_s", "design_s", "code_s"):
                print(f"  {k[:-2]}: {st[k]:.4f}s")
        _print_stats(opts, st["rate"], st["distortion"], elapsed,
                     st["payload_bytes"])
        return 0

    if opts["hosts"] > 1:
        # N worker processes over contiguous read ranges; with streaming,
        # the workers stream their ranges and the container is written
        # straight to disk
        if opts["reuse_books"]:
            raise ValueError("--hosts does not support --reuse-books")
        from qvz_tpu_torch.parallel.multihost import encode_multihost
        compressed, mh = encode_multihost(
            input_name, n_hosts=opts["hosts"], streaming=streaming,
            output_path=output_name if streaming else None, **common)
        if compressed is not None:
            with open(output_name, "wb") as f:
                f.write(compressed)
        elapsed = time.perf_counter() - t0
        if opts["verbose"]:
            print(f"Multi-host encode: {mh['hosts']} hosts, "
                  f"{mh['shards']} shards, {mh['lines']} lines.")
        _print_stats(opts, mh["rate"], mh["distortion"], elapsed,
                     mh["payload_bytes"])
        return 0

    from qvz_tpu_torch.pipeline import encode as enc_mod
    from qvz_tpu_torch.spec.pipeline import lines_to_bytes, load_quality_file

    out = enc_mod.encode(
        load_quality_file(input_name), dist,
        n_clusters=opts["clusters"], mode=opts["mode"],
        ratio=opts["ratio"], cluster_threshold=opts["cluster_threshold"],
        well_state=common["well_state"], shards=opts["shards"],
        reuse_blocks=_reuse_blocks(opts),
        want_recon=bool(opts["uncompressed"]), prime=opts["prime"],
        verbose=opts["verbose"], device=opts["device"])
    with open(output_name, "wb") as f:
        f.write(out.compressed)
    if opts["uncompressed"]:
        with open(opts["uncompressed"], "wb") as f:
            f.write(lines_to_bytes(out.reconstructed))
    elapsed = time.perf_counter() - t0
    s = out.stats
    if opts["profile_dir"]:
        _write_profile(opts["profile_dir"], s, elapsed)
    if opts["verbose"]:
        print(f"Lines: {s.lines}")
        print(f"Columns: {s.columns}")
        print(f"Total bytes used: {s.payload_bytes}")
        print(f"Encoding took {elapsed:.4f} seconds.")
        for phase, sec in s.phase_seconds.items():
            print(f"  {phase}: {sec:.4f}s")
    _print_stats(opts, s.rate, s.distortion, elapsed, s.payload_bytes)
    return 0


def _extract(opts, input_name, output_name, t0) -> int:
    """-x: a QVZ2 container across --hosts N worker processes (on the
    host), else the device decode (pipeline/decode.py)."""
    from qvz_tpu_torch.format import container_v2

    if opts["hosts"] > 1:
        with open(input_name, "rb") as f:
            magic = f.read(4)
        if container_v2.is_v2(magic):
            from qvz_tpu_torch.parallel.multihost import decode_multihost
            n = decode_multihost(input_name, output_name,
                                 n_hosts=opts["hosts"])
            if opts["verbose"]:
                print(f"Decoded {n} lines on {opts['hosts']} hosts "
                      f"in {time.perf_counter() - t0:.4f} seconds.")
            return 0
        # a v1 container is one sequential stream: decoded as below
    from qvz_tpu_torch.pipeline import decode as dec_mod
    n = dec_mod.decode_file_to_file(input_name, output_name,
                                    verbose=opts["verbose"],
                                    device=opts["device"])
    if opts["verbose"]:
        print(f"Decoded {n} lines in {time.perf_counter() - t0:f} seconds.")
    return 0


def _reuse_blocks(opts) -> bytes | None:
    """The codebook blocks of the --reuse-books container (v1 or QVZ2),
    after checking its cluster count against -c."""
    if not opts["reuse_books"]:
        return None
    from qvz_tpu_torch.format import container, container_v2

    with open(opts["reuse_books"], "rb") as f:
        prev = f.read()
    if container_v2.is_v2(prev):
        cc = container_v2.parse(prev, blocks_len=None).cluster_count
        blocks = prev[container_v2.header_size():]
    else:
        cc = container.read_header(prev[:9])[0]
        blocks = prev[9:]
    if cc != opts["clusters"]:
        raise ValueError("--reuse-books cluster count mismatch")
    return blocks


def _write_profile(pdir: str, s, elapsed: float) -> None:
    """--profile D: the encode's phase timings as D/phases.json, with
    qvz_tpu's keys."""
    import json
    import pathlib

    path = pathlib.Path(pdir)
    path.mkdir(parents=True, exist_ok=True)
    (path / "phases.json").write_text(json.dumps({
        "lines": s.lines, "columns": s.columns, "rate": s.rate,
        "distortion": s.distortion, "payload_bytes": s.payload_bytes,
        "total_seconds": elapsed, "phase_seconds": s.phase_seconds,
        "device_seconds": s.device_seconds,
        "throughput_MBps": s.lines * (s.columns + 1)
        / max(elapsed, 1e-9) / 1e6,
    }, indent=2))


def _print_stats(opts, rate, distortion, elapsed, payload_bytes) -> None:
    if opts["stats"]:
        # machine-parseable line, format-compatible with main.c:125
        print(f"rate, {rate:.4f}, distortion, {distortion:.4f}, "
              f"time, {elapsed:.4f}, size, {payload_bytes} ")
