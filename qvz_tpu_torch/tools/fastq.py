"""FASTQ quality-line extraction / reinsertion (a copy of
``qvz_tpu.tools.fastq``).

The codec (like reference qvz, README.md:27-29) operates on bare
quality-value files: one fixed-length line per read. FASTQ interleaves
them as every fourth line; the reference leaves extraction to the user.
This tool provides it:

    python -m qvz_tpu_torch.tools.fastq extract  in.fastq  out.qual
    python -m qvz_tpu_torch.tools.fastq reinsert in.fastq  in.qual  out.fastq

`reinsert` replaces the quality lines of a FASTQ template with the
(typically lossy-decoded) lines from a quality file, preserving
headers, sequences and separators byte-for-byte.
"""

from __future__ import annotations

import sys

_CHUNK = 1 << 24


def extract(fastq_path: str, qual_path: str) -> int:
    n = 0
    with open(fastq_path, "rb") as f, open(qual_path, "wb") as out:
        for i, line in enumerate(f):
            if i % 4 == 3:
                out.write(line if line.endswith(b"\n") else line + b"\n")
                n += 1
    return n


def reinsert(fastq_path: str, qual_path: str, out_path: str) -> int:
    n = 0
    with open(fastq_path, "rb") as f, open(qual_path, "rb") as q, \
            open(out_path, "wb") as out:
        for i, line in enumerate(f):
            if i % 4 == 3:
                repl = q.readline()
                if not repl:
                    raise ValueError(
                        f"quality file ended early (read {n} lines)")
                if len(repl.rstrip(b"\n")) != len(line.rstrip(b"\n")):
                    raise ValueError(
                        f"length mismatch at read {n}: "
                        f"{len(repl.rstrip())} vs {len(line.rstrip())}")
                out.write(repl if repl.endswith(b"\n") else repl + b"\n")
                n += 1
            else:
                out.write(line)
        if q.readline():
            raise ValueError("quality file has extra lines")
    return n


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    try:
        cmd = argv[1]
        if cmd == "extract":
            n = extract(argv[2], argv[3])
            print(f"extracted {n} quality lines")
        elif cmd == "reinsert":
            n = reinsert(argv[2], argv[3], argv[4])
            print(f"reinserted {n} quality lines")
        else:
            raise IndexError
    except IndexError:
        print(__doc__, file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
