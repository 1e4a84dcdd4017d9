"""Distortion matrices (reference: src/distortion.c); a copy of
``qvz_tpu.ops.distortion``.

A 72x72 float64 matrix D[x, y] giving the cost of reconstructing true
symbol x as symbol y. Values must match the reference's doubles exactly
because quantizer-design argmin decisions key off them:
  * MSE: (x-y)^2                      (distortion.c:66-77)
  * L1 / Manhattan: |x-y|             (distortion.c:50-61)
  * Lorentzian: log2(1+|x-y|)         (distortion.c:82-93) -- computed via
    math.log2 which calls the platform libm, same as the reference binary.
  * Custom: comma-separated file, '#' comment lines, missing fields filled
    with 0.0 (distortion.c:100-145; the reference's missing-field handler
    loops forever -- we fill-and-warn instead, a documented divergence).
"""

from __future__ import annotations

import math
import warnings

import numpy as np

from qvz_tpu_torch.constants import (
    ALPHABET_SIZE,
    DISTORTION_CUSTOM,
    DISTORTION_LORENTZ,
    DISTORTION_MANHATTAN,
    DISTORTION_MSE,
)


def mse_matrix(symbols: int = ALPHABET_SIZE) -> np.ndarray:
    x = np.arange(symbols, dtype=np.float64)
    d = x[:, None] - x[None, :]
    return d * d


def manhattan_matrix(symbols: int = ALPHABET_SIZE) -> np.ndarray:
    x = np.arange(symbols, dtype=np.float64)
    return np.abs(x[:, None] - x[None, :])


def lorentzian_matrix(symbols: int = ALPHABET_SIZE) -> np.ndarray:
    out = np.empty((symbols, symbols), dtype=np.float64)
    for x in range(symbols):
        for y in range(symbols):
            out[x, y] = math.log2(1.0 + abs(x - y))
    return out


def custom_matrix(path: str, symbols: int = ALPHABET_SIZE) -> np.ndarray:
    out = np.zeros((symbols, symbols), dtype=np.float64)
    x = 0
    with open(path, "rt") as fp:
        for line in fp:
            if x >= symbols:
                break
            if line.startswith("#"):
                continue
            fields = line.rstrip("\n").split(",")
            n = min(len(fields), symbols)
            for y in range(n):
                try:
                    out[x, y] = float(fields[y].strip() or 0.0)
                except ValueError:
                    out[x, y] = 0.0
            if n < symbols:
                warnings.warn(
                    f"distortion row {x}: missing fields filled with 0.0")
            x += 1
    return out


def make_matrix(kind: int, symbols: int = ALPHABET_SIZE,
                path: str | None = None) -> np.ndarray:
    if kind == DISTORTION_MSE:
        return mse_matrix(symbols)
    if kind == DISTORTION_MANHATTAN:
        return manhattan_matrix(symbols)
    if kind == DISTORTION_LORENTZ:
        return lorentzian_matrix(symbols)
    if kind == DISTORTION_CUSTOM:
        if path is None:
            raise ValueError("custom distortion requires a file path")
        return custom_matrix(path, symbols)
    raise ValueError(f"invalid distortion type {kind}")
