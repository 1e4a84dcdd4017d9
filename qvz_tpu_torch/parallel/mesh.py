"""The devices of a multi-device encode (counterpart of
``qvz_tpu.parallel.mesh``).

The one data axis of QVZ is the reads, so a mesh is an ordered list of
devices, one contiguous block of reads each (``parallel/sharded.py``):
statistics and k-means accumulators are exact integer sums merged across
the blocks, the codebook tables are copied to each device, and the
quantization and the lane coding of a block stay on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from qvz_tpu_torch.device import resolve


@dataclass(frozen=True)
class DeviceMesh:
    """An ordered tuple of devices; a device may appear more than once
    (several blocks on one card, or on the CPU in the tests)."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None,
              devices=None) -> DeviceMesh:
    """The mesh of the first n_devices CUDA cards (all visible cards where
    None), or of the explicit `devices` (names or torch.device, repeats
    allowed, such as ``["cuda:0"] * 4`` or ``["cpu"] * 8``). Raises where
    fewer cards are visible than asked for; no device is repeated in their
    place."""
    if devices is not None:
        if n_devices is not None:
            raise ValueError("give n_devices or devices, not both")
        devs = []
        for d in devices:
            d = resolve(d)
            if d.type == "cuda":
                idx = torch.cuda.current_device() if d.index is None \
                    else d.index
                if idx >= torch.cuda.device_count():
                    raise RuntimeError(
                        f"device {d} was asked for but "
                        f"{torch.cuda.device_count()} CUDA devices are "
                        "visible")
                d = torch.device("cuda", idx)
            devs.append(d)
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if n_devices is None else n_devices
        if want < 1 or want > have:
            raise RuntimeError(f"a mesh of {want} CUDA devices was asked "
                               f"for but {have} are visible")
        devs = [torch.device("cuda", i) for i in range(want)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(tuple(devs))
