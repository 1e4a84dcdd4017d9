"""Command-line interface of the port, flag-compatible with reference qvz
for the device QVZ2 encode and decode.

Usage: python -m qvz_tpu_torch (options) [input file] [output file]

Flags as ``python -m qvz_tpu`` (src/main.c:166-184): -q/-x/-f/-r/-d/-D/
-c/-T/-u/-h/-s/-v, --debug-seed, --well-state F, --shards N (0, the
default, picks the device lane count; N >= 2 pins it), --no-prime, plus
--device cuda|cpu (default cuda), which takes the place of --jax.
-c K > 1 clusters the reads with k-means on the device first.
--shards 1 codes the reference-compatible v1 container on the host engine
after the device statistics.
-x decodes a column-major QVZ2 container's lanes on --device (the lane
decoder K5, as ``python -m qvz_tpu -x --jax`` decodes them on the TPU);
v1 and other containers without lanes decode on the port's host decoder.
--hosts, --streaming, --reuse-books and --profile are not ported yet and
stop with an error that names the ROADMAP item.
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

_NOT_PORTED = {
    "--hosts": "item 9",
    "--streaming": "item 9",
    "--reuse-books": "item 10",
    "--profile": "item 10",
}


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
        "prime": True, "device": "cuda",
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
            elif a in _NOT_PORTED:
                print(f"Error: {a} is not ported to qvz_tpu_torch yet "
                      f"(ROADMAP.md, 'Modules to port' {_NOT_PORTED[a]})")
                return 1
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
    except (ValueError, NotImplementedError) as e:
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
        from qvz_tpu_torch.pipeline import decode as dec_mod
        n = dec_mod.decode_file_to_file(input_name, output_name,
                                        verbose=opts["verbose"],
                                        device=opts["device"])
        if opts["verbose"]:
            print(f"Decoded {n} lines in "
                  f"{time.perf_counter() - t0:f} seconds.")
        return 0

    from qvz_tpu_torch.pipeline import encode as enc_mod
    from qvz_tpu_torch.spec.pipeline import lines_to_bytes, load_quality_file

    out = enc_mod.encode(
        load_quality_file(input_name),
        make_matrix(opts["distortion"], path=opts["dist_file"]),
        n_clusters=opts["clusters"], mode=opts["mode"],
        ratio=opts["ratio"], cluster_threshold=opts["cluster_threshold"],
        well_state=_make_well(opts), shards=opts["shards"],
        want_recon=bool(opts["uncompressed"]), prime=opts["prime"],
        verbose=opts["verbose"], device=opts["device"])
    with open(output_name, "wb") as f:
        f.write(out.compressed)
    if opts["uncompressed"]:
        with open(opts["uncompressed"], "wb") as f:
            f.write(lines_to_bytes(out.reconstructed))
    elapsed = time.perf_counter() - t0
    s = out.stats
    if opts["verbose"]:
        print(f"Lines: {s.lines}")
        print(f"Columns: {s.columns}")
        print(f"Total bytes used: {s.payload_bytes}")
        print(f"Encoding took {elapsed:.4f} seconds.")
        for phase, sec in s.phase_seconds.items():
            print(f"  {phase}: {sec:.4f}s")
    if opts["stats"]:
        # machine-parseable line, format-compatible with main.c:125
        print(f"rate, {s.rate:.4f}, distortion, {s.distortion:.4f}, "
              f"time, {elapsed:.4f}, size, {s.payload_bytes} ")
    return 0
