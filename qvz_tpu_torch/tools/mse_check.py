"""Distortion checker between two quality files (a copy of
``qvz_tpu.tools.mse_check``).

Reference counterpart: src/mse_check.c (33 LoC, standalone, hardcoded to
36 columns x 500000 lines and MSE only). This version derives the
geometry from the files, supports every distortion metric the codec
knows (MSE / L1 / Lorentzian / custom matrix), and reports both the
per-line mean (the reference tool's figure) and the codec's -s
accounting (mean over lines of per-line column-mean, main.c:103-121).

Usage: python -m qvz_tpu_torch.tools.mse_check [-d M|L|A] [-D FILE] a.txt b.txt
"""

from __future__ import annotations

import sys

import numpy as np

from qvz_tpu_torch.constants import (
    DISTORTION_CUSTOM,
    DISTORTION_LORENTZ,
    DISTORTION_MANHATTAN,
    DISTORTION_MSE,
)
from qvz_tpu_torch.ops.distortion import make_matrix
from qvz_tpu_torch.spec.pipeline import load_quality_file


def compare(a: np.ndarray, b: np.ndarray, dist: np.ndarray) -> dict:
    if a.shape != b.shape:
        raise ValueError(f"geometry mismatch: {a.shape} vs {b.shape}")
    n, cols = a.shape
    d = dist[a.reshape(-1), b.reshape(-1)].reshape(n, cols)
    line_sums = d.sum(axis=1, dtype=np.float64)
    return {
        "lines": n,
        "columns": cols,
        "total": float(line_sums.sum()),
        "per_symbol": float(line_sums.sum() / (n * cols)),
        # the codec's -s figure: mean over lines of per-line column mean
        "stats_line": float((line_sums / cols).mean()),
        "max_line": float(line_sums.max() / cols),
    }


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    kind, dist_file = DISTORTION_MSE, None
    files = []
    i = 1
    while i < len(argv):
        a = argv[i]
        if a == "-d":
            sel = argv[i + 1][0]
            kind = {"M": DISTORTION_MSE, "L": DISTORTION_LORENTZ,
                    "A": DISTORTION_MANHATTAN}.get(sel, DISTORTION_MSE)
            i += 2
        elif a == "-D":
            kind, dist_file = DISTORTION_CUSTOM, argv[i + 1]
            i += 2
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            files.append(a)
            i += 1
    if len(files) != 2:
        print("usage: mse_check [-d M|L|A] [-D FILE] original.txt "
              "reconstructed.txt", file=sys.stderr)
        return 1
    dist = make_matrix(kind, path=dist_file)
    try:
        r = compare(load_quality_file(files[0]),
                    load_quality_file(files[1]), dist)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"lines, {r['lines']}, columns, {r['columns']}, "
          f"distortion, {r['stats_line']:.6f}, per_symbol, "
          f"{r['per_symbol']:.6f}, max_line, {r['max_line']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
