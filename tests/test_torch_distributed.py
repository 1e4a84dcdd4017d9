"""qvz_tpu_torch.parallel.distributed on the CPU: two processes over Gloo
hold unequal row blocks of one input, reduce their K3 counts with one
all-reduce, and both get qvz_tpu's single-process counts and design the
same codebook blocks (the counterpart of tests/test_distributed.py)."""

import hashlib
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as tdist

from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu_torch.parallel import distributed

REPO = pathlib.Path(__file__).resolve().parent.parent

WORKER = r'''
import hashlib, sys
import numpy as np
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from qvz_tpu_torch.parallel import distributed as dist
dist.initialize(f"tcp://localhost:{port}", nproc, pid, device="cpu")
rng = np.random.default_rng(7)      # the same corpus in every rank
n, cols, k = 4000, 24, 3
start = rng.integers(20, 45, size=(n, 1))
steps = rng.integers(-3, 4, size=(n, cols - 1))
full = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
               71).astype(np.uint8)
cl = (np.arange(n) % k).astype(np.uint8)
lo, hi = (0, 1701) if pid == 0 else (1701, n)     # unequal blocks
c0, cond = dist.distributed_conditional_counts(full[lo:hi], cl[lo:hi], k,
                                               device="cpu")
from qvz_tpu_torch.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu_torch.native import runtime as rt
from qvz_tpu_torch.ops.distortion import make_matrix
blocks = rt.Design(c0, cond, MODE_RATIO, 0.5,
                   make_matrix(DISTORTION_MSE)).serialized()
import torch.distributed
torch.distributed.destroy_process_group()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "qvz_tpu")]
assert not bad, bad
print(f"RANK {pid} c0 {hashlib.sha256(c0.tobytes()).hexdigest()} "
      f"cond {hashlib.sha256(cond.tobytes()).hexdigest()} "
      f"blocks {hashlib.sha256(blocks).hexdigest()}", flush=True)
'''


def _env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_two_process_gloo_stats_and_design():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), "2", str(port)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(next(ln for ln in out.splitlines()
                         if ln.startswith("RANK")).split()[2:])
    assert outs[0] == outs[1], f"ranks disagree: {outs}"

    rng = np.random.default_rng(7)
    n, cols, k = 4000, 24, 3
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    full = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    cl = (np.arange(n) % k).astype(np.uint8)
    c0, cond = rt.stats_host(full, cl, k)
    blocks = rt.Design(c0, cond, MODE_RATIO, 0.5,
                       make_matrix(DISTORTION_MSE)).serialized()
    want = [hashlib.sha256(np.ascontiguousarray(c0, np.int64).tobytes())
            .hexdigest(),
            hashlib.sha256(np.ascontiguousarray(cond, np.int64).tobytes())
            .hexdigest(), hashlib.sha256(blocks).hexdigest()]
    assert outs[0] == ["c0", want[0], "cond", want[1], "blocks", want[2]]


def test_backends_are_checked(monkeypatch):
    """A missing backend raises; nothing falls back to another one."""
    monkeypatch.setattr(tdist, "is_gloo_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo backend is not available"):
        distributed.initialize("localhost:1", device="cpu")
    monkeypatch.setattr(tdist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl backend is not available"):
        distributed.initialize("localhost:1", backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="unsupported backend"):
        distributed.initialize("localhost:1", backend="mpi", device="cpu")
    assert not tdist.is_initialized()


def test_cuda_default_without_a_card_raises(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.setattr(distributed, "_device", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("localhost:1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.distributed_conditional_counts(
            np.zeros((4, 3), np.uint8), None, 1, device="cuda")
    # the default device is the one initialize gave the process
    with pytest.raises(RuntimeError, match="initialize"):
        distributed.distributed_conditional_counts(
            np.zeros((4, 3), np.uint8), None, 1)


@pytest.mark.parametrize("env, args, want", [
    ({"LOCAL_RANK": "2", "RANK": "6"}, (None,), 2),     # torchrun, env://
    ({"RANK": "5"}, (None,), 1),                        # env:// alone
    ({"LOCAL_RANK": "2"}, ("localhost:1", 8, 5), 1),    # coordinator
    ({}, ("localhost:1", 8, 6, None, "cuda:3"), 3),     # an explicit card
])
def test_each_rank_takes_its_own_card(monkeypatch, env, args, want):
    """On a host of 4 cards, initialize makes the rank's own card current
    (LOCAL_RANK under env://, else the rank modulo the cards, unless a
    card is named) and the statistics default to it (rank_device)."""
    import torch
    for k in ("LOCAL_RANK", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(distributed, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tdist, "is_nccl_available", lambda: True)
    current, groups = [], []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda backend, **kw: groups.append(backend))
    distributed.initialize(*args)
    card = torch.device("cuda", want)
    assert current == [card] and groups == ["nccl"]
    assert distributed.rank_device() == card


def test_counts_default_to_the_rank_device(monkeypatch):
    """distributed_conditional_counts without a device runs on
    rank_device() (here the CPU, K3's plain version) and reduces once
    a tensor."""
    import torch
    monkeypatch.setattr(distributed, "_device", torch.device("cpu"))
    reduced = []
    monkeypatch.setattr(tdist, "all_reduce",
                        lambda t, op: reduced.append(t.device))
    rng = np.random.default_rng(3)
    data = rng.integers(0, 72, size=(300, 9)).astype(np.uint8)
    cl = (np.arange(300) % 2).astype(np.uint8)
    c0, cond = distributed.distributed_conditional_counts(data, cl, 2)
    want = rt.stats_host(data, cl, 2)
    assert np.array_equal(c0, want[0]) and np.array_equal(cond, want[1])
    assert reduced == [torch.device("cpu")] * 2
