"""The card's peak rates, and the least time a kernel could take.

A kernel's bound is the larger of two times: its bytes (each input read
once, each output written once) over the device memory's rate, 3.35 TB/s
(NVIDIA's data sheet for the H100 SXM), and its operations over the
card's peak rate for them. The peaks, per SM and clock, at the top SM
clock that nvidia-smi reads:

  ALU pipe        64 lanes: integer add, logic, compare, select, shift
                  (IADD3, LOP3, ISETP, SEL, LEA, SHF, IMNMX)
  FMA pipe        64 lanes for the integer multiply-add IMAD (and its
                  MOV, IADD and SHL forms)
  issue           4 schedulers x one warp instruction of 32 threads: 128
                  thread instructions of any kind
  shared memory   32 words of 4 bytes (a load, a store or an atomic of
                  one word each)

``pipe_bound`` takes a kernel's instructions counted from its SASS and is
bound by the slowest pipe. ``bound`` takes an estimated count of int32
instructions and is bound at the issue rate, the most that the card's two
integer pipes together can start. Nothing here runs at import time.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12
ALU_LANES_PER_SM = 64
FMA_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128
SHARED_WORDS_PER_SM = 32
ALU_OPS = frozenset({"IADD3", "LOP3", "ISETP", "SEL", "LEA", "SHF", "IMNMX"})
FMA_OPS = frozenset({"IMAD"})


class Card(NamedTuple):
    name: str       # nvidia-smi's name and power limit
    sms: int
    hz: float       # the top SM clock

    def per_s(self, lanes_per_sm: int) -> float:
        return self.sms * lanes_per_sm * self.hz

    @property
    def int32_per_s(self) -> float:
        return self.per_s(ISSUE_LANES_PER_SM)


def smi(query: str) -> str:
    """One nvidia-smi query of the card, as csv without a header."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card(dev=0) -> Card:
    mhz = float(smi("clocks.max.sm").split()[0])       # "1980 MHz"
    return Card(smi("name,power.limit"),
                torch.cuda.get_device_properties(dev).multi_processor_count,
                mhz * 1e6)


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(least ms, "bytes" or "operations"): the bytes over the memory
    rate against the operations over `ops_per_s`."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pipe_ms(gpu: Card, per_elem: dict, elems: float, nbytes: float) -> dict:
    """The least ms of each pipe, and of device memory, for `elems`
    elements of `per_elem` instructions ("alu", "fma", "issue") and
    shared-memory words ("shared") each."""
    return {"memory": nbytes / HBM_BYTES_PER_S * 1e3,
            "alu": per_elem["alu"] * elems / gpu.per_s(ALU_LANES_PER_SM)
            * 1e3,
            "fma": per_elem["fma"] * elems / gpu.per_s(FMA_LANES_PER_SM)
            * 1e3,
            "issue": per_elem["issue"] * elems
            / gpu.per_s(ISSUE_LANES_PER_SM) * 1e3,
            "shared": per_elem["shared"] * elems
            / gpu.per_s(SHARED_WORDS_PER_SM) * 1e3}


def pipe_bound(gpu: Card, per_elem: dict, elems: float, nbytes: float):
    """(least ms, "bytes" or "operations", the pipe that binds)."""
    t = pipe_ms(gpu, per_elem, elems, nbytes)
    pipe = max(t, key=t.get)
    return t[pipe], "bytes" if pipe == "memory" else "operations", pipe
