"""Quality-file I/O of the reference's driver (src/lines.c), copied from
``qvz_tpu.spec.pipeline``."""

from __future__ import annotations

import os

import numpy as np

from qvz_tpu_torch.constants import PHRED_OFFSET


def load_quality_file(path_or_bytes):
    """Parse a quality file into (N, cols) 0-based symbols (lines.c:27-82).

    Columns come from the first line's length; the line count is
    filesize // (columns+1) so a truncated trailing line is ignored.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = np.frombuffer(bytes(path_or_bytes), dtype=np.uint8)
    else:
        # memory-map like the reference (lines.c:64): pages fault in on
        # demand, so multi-GB files don't need an upfront read. Hint
        # sequential access so cold-cache reads ride kernel readahead.
        if hasattr(os, "posix_fadvise"):
            try:
                fd = os.open(path_or_bytes, os.O_RDONLY)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_SEQUENTIAL)
                os.close(fd)
            except OSError:
                pass
        raw = np.memmap(path_or_bytes, dtype=np.uint8, mode="r")
    head = np.asarray(raw[: min(len(raw), 1 << 20)])
    nl = np.nonzero(head == ord("\n"))[0]
    if len(nl) == 0:
        raise ValueError("no newline found in quality file")
    columns = int(nl[0])
    lines = len(raw) // (columns + 1)
    data = raw[: lines * (columns + 1)].reshape(lines, columns + 1)
    # Framing check (divergence from the reference, which silently
    # mis-frames ragged files): every line must be `columns` long.
    bad = np.nonzero(data[:, columns] != ord("\n"))[0]
    if len(bad):
        raise ValueError(
            f"line {int(bad[0]) + 1} is not {columns} symbols long "
            "(all quality lines must have equal length)")
    # subtracting the Phred offset materializes the symbol matrix once
    # Strided Phred-strip copy (drops the newline column); threaded
    # over row blocks — numpy releases the GIL, and the single-threaded
    # strided copy was the load bottleneck at GB scale (10.7 s -> ~3 s
    # for 1 GB on 4 cores).
    n = data.shape[0]
    sym = np.empty((n, columns), dtype=np.uint8)
    if n >= 1 << 20:
        from concurrent.futures import ThreadPoolExecutor
        nt = min(8, os.cpu_count() or 1)
        block = -(-n // nt)

        def strip(t):
            lo, hi = t * block, min(n, (t + 1) * block)
            np.subtract(data[lo:hi, :columns], PHRED_OFFSET,
                        out=sym[lo:hi])

        with ThreadPoolExecutor(max_workers=nt) as ex:
            list(ex.map(strip, range(nt)))
    else:
        np.subtract(data[:, :columns], PHRED_OFFSET, out=sym)
    return sym


def lines_to_bytes(symbols: np.ndarray) -> bytes:
    """Symbols (N, cols) -> Phred+33 text with newlines."""
    n, cols = symbols.shape
    out = np.empty((n, cols + 1), dtype=np.uint8)
    out[:, :cols] = symbols + PHRED_OFFSET
    out[:, cols] = ord("\n")
    return out.tobytes()
