"""The statistics across processes over torch.distributed (counterpart of
``qvz_tpu.parallel.distributed``, which runs them over jax.distributed).

Each process holds its own contiguous rows of the reads; K3 counts them
on its device and one all-reduce sums the exact int64 counts, so every
process gets the same global statistics, equal to one pass over the
concatenated rows, and designs the same codebooks. Processes may hold
different numbers of rows: nothing is padded.

    from qvz_tpu_torch.parallel import distributed as dist
    dist.initialize("tcp://host:port", num_processes=2, process_id=rank)
    counts0, cond = dist.distributed_conditional_counts(rows, ids, k)

Nothing on the machine announces a cluster: give the coordinator's
address, the world size and the rank, or start the processes with
torchrun, whose MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK
``initialize_from_env`` reads. The backend is NCCL for CUDA devices and
Gloo for the CPU; a backend this PyTorch lacks raises. On a host of
several cards each process takes its own: torchrun's LOCAL_RANK, else its
rank modulo the cards visible (``rank_device``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist

from qvz_tpu_torch.device import resolve
from qvz_tpu_torch.ops import stats as dev_stats

# The device `initialize` gave this process (its own card where CUDA).
_device: torch.device | None = None


def initialize(coordinator: str | None = None, num_processes: int = 1,
               process_id: int = 0, backend: str | None = None,
               device: str | torch.device = "cuda") -> None:
    """Join the process group: with a coordinator ("tcp://host:port", or
    "host:port") as process process_id of num_processes; without one from
    torchrun's environment (env://, which also gives the world size and
    the rank). backend: "nccl" or "gloo", by default NCCL where `device`
    is a CUDA device and Gloo on the CPU. Two processes on one card need
    Gloo: NCCL refuses them. A CUDA device without an index becomes the
    process's own card, made current: LOCAL_RANK under env://, else
    process_id modulo the cards visible."""
    global _device
    dev = resolve(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    available = {"nccl": tdist.is_nccl_available,
                 "gloo": tdist.is_gloo_available}
    if backend not in available:
        raise ValueError(f"unsupported backend {backend!r}: use 'nccl' or "
                         "'gloo'")
    if not available[backend]():
        raise RuntimeError(f"the {backend} backend is not available in "
                           "this PyTorch")
    if dev.type == "cuda":
        if dev.index is None:
            local = (os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))
                     if coordinator is None else process_id)
            dev = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _device = dev
    if coordinator is None:
        tdist.init_process_group(backend, init_method="env://")
    else:
        if "://" not in coordinator:
            coordinator = f"tcp://{coordinator}"
        tdist.init_process_group(backend, init_method=coordinator,
                                 world_size=num_processes, rank=process_id)


def initialize_from_env(backend: str | None = None,
                        device: str | torch.device = "cuda") -> None:
    """``initialize`` from torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE
    and RANK, on the card of its LOCAL_RANK."""
    initialize(None, backend=backend, device=device)


def rank_device() -> torch.device:
    """The device ``initialize`` gave this process: its own card, or the
    CPU. Raises before ``initialize``."""
    if _device is None:
        raise RuntimeError("initialize() has not been called")
    return _device


def distributed_conditional_counts(data_local: np.ndarray, clusters_local,
                                   n_clusters: int,
                                   device: str | torch.device | None = None):
    """The global statistics from this process's (n_local, cols) uint8
    rows and (n_local,) uint8 cluster ids (None with one cluster): K3 on
    `device` (``rank_device()`` where None), then one all-reduce (sum) of
    the int64 counts over the process group. Returns int64 numpy (counts0
    (C, 72), cond (C, cols - 1, 72, 72)), the same on every process and
    equal to one pass over the rows of all processes in rank order."""
    dev = rank_device() if device is None else resolve(device)
    # writable host copies where the rows are a read-only map
    rows = np.require(data_local, np.uint8, ["C", "W"])
    data_t = torch.from_numpy(rows).to(dev).t().contiguous()
    ids = (None if clusters_local is None else torch.from_numpy(
        np.require(clusters_local, np.uint8, ["C", "W"])).to(dev))
    counts = dev_stats.conditional_counts_t(data_t, ids, n_clusters)
    for t in counts:
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM)
    return tuple(t.cpu().numpy() for t in counts)
