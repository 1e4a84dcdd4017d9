"""Explicit device selection: every entry point takes a ``device``.

``"cuda"`` without a visible card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was asked for but no CUDA device is "
                "visible")
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' "
                         "or 'cpu'")
    return d


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

