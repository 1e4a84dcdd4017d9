"""Integer-issue microbenchmark of the card for the lane coder's op mix.

    python -m qvz_tpu_torch.microbench      # on a CUDA card

Counterpart of ``scripts/vpu_microbench.py``, which measures a TPU's
vector unit; the CUDA kernels of ``csrc/microbench.cu`` replace its three
Pallas kernels. The legs are the script's (``LEGS``):

  issue_*      8 loop-carried int32 chains a tile element over (8, 128)
               tiles: the issue rate of add/xor (2 ops) and of
               compare/subtract/select (3 ops) from registers.
  codermix_*   the coder's per-chunk op mix, 10 ops an element (d = kw - m,
               an unsigned below-compare, an eq-compare, two masked sums by
               multiply, the eq-update of the counts c kept in fast memory)
               on four layouts of one 2 MB working set.
  codermix_sel / selb4 / sweeponly
               the mix with selects for the products (9 ops), 4 steps
               sharing one load (8 ops a step), a load-and-add sweep (1).

Each leg runs first at reps 6 at the TPU script's shape, where the
kernel must equal its plain PyTorch version element for element and the
checksum the script's NumPy replay; then at its timed reps, equal to the
plain version again (the issue legs at reps 4096), and is timed (CUDA
events, median of 5 after a warm-up). The mix legs run twice: at the
TPU's shape (2 MB, element-equal to the TPU kernel's output) and at the
same trailing shape with the leading axis scaled until c and kw fill
about 200 KB of shared memory on every SM (tag suffix ``@card``), the
card-wide rate. Each leg reports Top/s by the script's source-op count
and by the SASS instructions of its kernel's inner loop (read with
``cuobjdump -sass`` from the built library), elements/s, the replication
(``tiles``, or rows and blocks), the SM clock and power draw that
nvidia-smi reads while the leg keeps the card busy, and its bound: the
least time of each pipe for the loop's instructions and shared-memory
words (``roofline.pipe_ms``), the slowest of which bounds. A leg that
runs faster than its bound fails.

``main()`` writes ``build/microbench_torch.json``, with the card's name
and power limit on every leg; it never writes the TPU record
``build/vpu_microbench.json``. The wrappers ``issue``, ``mix`` and
``selmix`` run their plain version on CPU tensors and launch their kernel
on CUDA tensors, or raise. Nothing runs at import time.
"""

from __future__ import annotations

import heapq
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from qvz_tpu_torch import _build, roofline
from qvz_tpu_torch.device import resolve

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "build" / "microbench_torch.json"

CHAINS = 8
TILE = (8, 128)
OPS_PER_ELEM = 10
CHECK_REPS = 6               # the TPU script's checksum reps
ISSUE_CHECK_REPS = 4096      # the issue legs' equality check on the card
BLOCKS_PER_SM = 2            # mix blocks resident on an SM
ISSUE_TILES_PER_SM = 2       # 2 x 1,024 issue threads: a full SM
FILL_BYTES = 200 * 1024      # c and kw in shared memory per SM, card-wide
MAX_SHARED = 227 * 1024
ISSUE_OPS = {"addxor": 0, "cmpsel": 1}
MIX_MODES = {"mix": 0, "sel": 1, "sel_b4": 2, "sweeponly": 3}
# each kernel's symbol in the built library, by leg op or mode
SYMBOLS = {"addxor": "qvz_mb_issue_addxor", "cmpsel": "qvz_mb_issue_cmpsel",
           "mix": "qvz_mb_mix", "sel": "qvz_mb_sel", "sel_b4": "qvz_mb_sel_b4",
           "sweeponly": "qvz_mb_sweeponly"}
SASS_OPS = ("IADD3", "LOP3", "ISETP", "SEL", "LEA", "VIADD", "IMAD", "LDS",
            "STS")


class Leg(NamedTuple):
    tag: str
    kernel: str            # "issue", "mix" or "selmix"
    variant: str           # the issue op or the mix mode
    shape: tuple | None    # the mix legs' kw/c shape
    reps: int
    ops_per_elem: int      # source ops an element a rep (a step for sel_b4)


# scripts/vpu_microbench.py:361-378
LEGS = (
    Leg("issue_addxor", "issue", "addxor", None, 2_000_000, 2 * CHAINS),
    Leg("issue_cmpsel", "issue", "cmpsel", None, 1_000_000, 3 * CHAINS),
    Leg("codermix_3d_w4", "mix", "mix", (1024, 4, 128), 8000, OPS_PER_ELEM),
    Leg("codermix_3d_w8", "mix", "mix", (512, 8, 128), 8000, OPS_PER_ELEM),
    Leg("codermix_2d_w512", "mix", "mix", (1024, 512), 8000, OPS_PER_ELEM),
    Leg("codermix_2d_w1024", "mix", "mix", (512, 1024), 8000, OPS_PER_ELEM),
    Leg("codermix_sel_3d_w8", "selmix", "sel", (512, 8, 128), 8000, 9),
    Leg("codermix_selb4_3d_w8", "selmix", "sel_b4", (512, 8, 128), 2000, 8),
    Leg("sweeponly_3d_w8", "selmix", "sweeponly", (512, 8, 128), 20000, 1),
)
# the leg of each kernel whose times stand in chip_smoke.py's kernels line
NAMED = {"issue": "issue_addxor", "mix": "codermix_3d_w8",
         "selmix": "codermix_sel_3d_w8"}
# the line of each kernel's pl.pallas_call in scripts/vpu_microbench.py
SOURCES = {"issue": 110, "mix": 198, "selmix": 331}


# -- plain PyTorch versions -------------------------------------------------

def _wrap(t: torch.Tensor) -> torch.Tensor:
    """int64 -> its value mod 2^32 as a signed int32, still int64."""
    return ((t & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def issue_reference(x: torch.Tensor, reps: int, op: str,
                    tiles: int = 1) -> torch.Tensor:
    """Plain version of the issue kernel: x (8, 8, 128) int32, chain k
    starts at x[k] + k; returns the chains' sum mod 2^32 for each of
    `tiles` copies, (tiles, 8, 128) int32."""
    k = torch.arange(CHAINS, device=x.device).view(CHAINS, 1, 1)
    xs = (x.long() + k).expand(tiles, CHAINS, *TILE)
    acc = xs.clone()
    for r in range(reps):
        if op == "addxor":
            acc = _wrap(acc + (xs ^ r))
        else:
            acc = _wrap(torch.where(acc > xs, acc - xs, acc + r))
    return _wrap(acc.sum(1)).to(torch.int32)


def _steps(r: int, mode: str):
    return [r] if mode != "sel_b4" else [r * 4 + k for k in range(4)]


def selmix_reference(reps: int, kw: torch.Tensor, c: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Plain version of the mix kernels (mode "mix", "sel", "sel_b4" or
    "sweeponly"): b0 + b1 summed over the leading axis and the reps, mod
    2^32, shape kw.shape[1:] (int32). "mix" and "sel" compute the same
    function (by products, by selects); "sel_b4" runs steps r*4 .. r*4+3
    on the counts of the rep's start and adds their 4 eq-updates at once;
    "sweeponly" adds c each rep."""
    kw64 = kw.long()
    cc = c.long().clone()
    b = torch.zeros(kw.shape[1:], dtype=torch.long, device=kw.device)
    for r in range(reps):
        if mode == "sweeponly":
            b += cc.sum(0)
            continue
        upd = torch.zeros_like(cc)
        for t in _steps(r, mode):
            m, qs = (t * 128) & 0x3FF, (t & 63) + 1
            d = kw64 - m
            below = (d >= 0) & (d < qs)     # u32(d) < qs, as 1 <= qs <= 64
            eq = d == qs
            if mode == "mix":
                b += (cc * below).sum(0) + (cc * eq).sum(0)
            else:
                z = torch.zeros_like(cc)
                b += (torch.where(below, cc, z).sum(0)
                      + torch.where(eq, cc, z).sum(0))
            upd += eq
        cc += upd
    return _wrap(b).to(torch.int32)


def mix_reference(reps: int, kw: torch.Tensor,
                  c: torch.Tensor) -> torch.Tensor:
    """Plain version of the coder-mix kernel; the output has the TPU
    kernel's shape: kw.shape[1:] for 3-D inputs, (1, W) for 2-D."""
    out = selmix_reference(reps, kw, c, "mix")
    return out if kw.dim() == 3 else out[None]


# -- the TPU script's NumPy replays (scripts/vpu_microbench.py:168, :297) --

def _mix_replay(kw, c, reps):
    # checksum of the two accumulators, mod 2^32
    kw = kw.astype(np.int64).ravel()
    cc = c.astype(np.int64).ravel().copy()
    s = 0
    for r in range(reps):
        m = (r * 128) & 0x3FF
        qs = (r & 63) + 1
        d = kw - m
        below = (d >= 0) & (d < qs)
        eq = d == qs
        s += (cc * below).sum() + (cc * eq).sum()
        cc += eq
    return int(s) % (1 << 32)


def _sel_replay(kw, c, reps, mode):
    kw = kw.astype(np.int64).ravel()
    cc = c.astype(np.int64).ravel().copy()
    s = 0
    if mode == "sweeponly":
        return int(reps * cc.sum()) % (1 << 32)
    for r in range(reps):
        if mode == "sel":
            steps = [r]
        else:
            steps = [r * 4 + k for k in range(4)]
        upd = 0
        for t in steps:
            m = (t * 128) & 0x3FF
            qs = (t & 63) + 1
            d = kw - m
            below = (d >= 0) & (d < qs)
            eq = d == qs
            s += (cc * below).sum() + (cc * eq).sum()
            upd = upd + eq
        cc += upd
    return int(s) % (1 << 32)


def checksum(out: torch.Tensor) -> int:
    """The TPU script's checksum: the output's sum mod 2^32."""
    return int(out.long().sum()) % (1 << 32)


# -- wrappers -----------------------------------------------------------------

def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def issue(x: torch.Tensor, reps: int, op: str,
          tiles: int = 1) -> torch.Tensor:
    """The issue kernel on `tiles` copies of the (8, 8, 128) int32 tile x:
    returns (tiles, 8, 128) int32, every copy the TPU kernel's (8, 128)
    output. CPU tensors take the plain version; CUDA tensors launch the
    kernel (csrc/microbench.cu) or raise."""
    if op not in ISSUE_OPS:
        raise ValueError(f"unknown issue op {op!r}")
    if x.dtype != torch.int32 or tuple(x.shape) != (CHAINS, *TILE):
        raise TypeError("x must be (8, 8, 128) int32")
    if not 0 <= reps < 2 ** 31 or tiles < 1:
        raise ValueError(f"reps {reps} and tiles {tiles} out of range")
    if x.device.type == "cpu":
        return issue_reference(x, reps, op, tiles)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _build.load()
    x = x.contiguous()
    out = torch.empty((tiles, *TILE), dtype=torch.int32, device=x.device)
    rc = lib.qvz_microbench_issue(x.data_ptr(), ISSUE_OPS[op], reps, tiles,
                                  out.data_ptr(), _stream(x.device))
    _build.check(rc, "issue kernel")
    _build.LAUNCHES["issue"] += 1
    return out


def rows_per_block(rows: int, sms: int) -> int:
    """Rows of the leading axis a mix block keeps in shared memory:
    BLOCKS_PER_SM blocks on every SM."""
    return -(-rows // (BLOCKS_PER_SM * sms))


def _check_mix(reps, kw, c):
    if kw.dtype != torch.int32 or c.dtype != torch.int32:
        raise TypeError("kw and c must be int32")
    if kw.shape != c.shape or kw.dim() not in (2, 3) or kw.numel() == 0:
        raise ValueError(f"kw {tuple(kw.shape)} and c {tuple(c.shape)} must "
                         "share one 2-D or 3-D shape")
    if kw.device != c.device:
        raise ValueError("kw and c must share one device")
    if not 0 <= reps < 2 ** 31 // 512:      # sel_b4's step t * 128 in int32
        raise ValueError(f"reps {reps} out of range")


def _launch_mix(mode: str, reps: int, kw: torch.Tensor, c: torch.Tensor,
                name: str) -> torch.Tensor:
    dev = kw.device
    lib = _build.load()
    rows, P = kw.shape[0], kw[0].numel()
    rpb = rows_per_block(rows, _sms(dev))
    if rpb * P * 8 > MAX_SHARED:
        raise ValueError(f"{rpb} rows of {P} do not fit in shared memory")
    kw, c = kw.contiguous(), c.contiguous()
    out = torch.zeros(P, dtype=torch.int32, device=dev)
    rc = lib.qvz_microbench_mix(MIX_MODES[mode], reps, kw.data_ptr(),
                                c.data_ptr(), rows, P, rpb, out.data_ptr(),
                                _stream(dev))
    _build.check(rc, f"{name} kernel")
    _build.LAUNCHES[name] += 1
    return out.view(kw.shape[1:])


def mix(reps: int, kw: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The coder-mix kernel over kw and c of shape (R, ...) int32: returns
    the TPU kernel's output, b0 + b1 summed over the leading axis and the
    reps mod 2^32, shape kw.shape[1:] (3-D) or (1, W) (2-D). c is not
    changed. CPU tensors take the plain version; CUDA tensors launch the
    kernel (csrc/microbench.cu) or raise."""
    _check_mix(reps, kw, c)
    if kw.device.type == "cpu":
        return mix_reference(reps, kw, c)
    if kw.device.type != "cuda":
        raise ValueError(f"unsupported device {kw.device}")
    out = _launch_mix("mix", reps, kw, c, "mix")
    return out if kw.dim() == 3 else out[None]


def selmix(reps: int, kw: torch.Tensor, c: torch.Tensor,
           mode: str) -> torch.Tensor:
    """The select-mix kernel, mode "sel", "sel_b4" or "sweeponly": returns
    (shape kw.shape[1:], int32) the TPU kernel's output. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if mode not in ("sel", "sel_b4", "sweeponly"):
        raise ValueError(f"unknown selmix mode {mode!r}")
    _check_mix(reps, kw, c)
    if kw.device.type == "cpu":
        return selmix_reference(reps, kw, c, mode)
    if kw.device.type != "cuda":
        raise ValueError(f"unsupported device {kw.device}")
    return _launch_mix(mode, reps, kw, c, "selmix")


# -- inputs -------------------------------------------------------------------

def issue_input(device="cpu") -> torch.Tensor:
    """The TPU script's tile set: arange % 97, (8, 8, 128) int32."""
    x = np.arange(CHAINS * 8 * 128, dtype=np.int32).reshape(CHAINS, 8, 128)
    return torch.from_numpy(x % 97).to(device)


def mix_input(shape, device="cpu"):
    """kw in 0..1023 and c in 0..4095, int32, from seed 7 as the TPU
    script makes them (numpy arrays and tensors on `device`)."""
    rng = np.random.default_rng(7)
    kw = rng.integers(0, 1 << 10, size=shape).astype(np.int32)
    c = rng.integers(0, 4096, size=shape).astype(np.int32)
    return kw, c, torch.from_numpy(kw).to(device), torch.from_numpy(c).to(
        device)


def card_shape(shape, sms: int) -> tuple:
    """The leg's trailing shape with the leading axis scaled so that c and
    kw fill about FILL_BYTES of shared memory on every SM."""
    P = int(np.prod(shape[1:]))
    rpb = FILL_BYTES // (BLOCKS_PER_SM * 8 * P)
    return (rpb * BLOCKS_PER_SM * sms, *shape[1:])


def run_kernel(leg: Leg, reps: int, kw=None, c=None, x=None, tiles=1):
    if leg.kernel == "issue":
        return issue(x, reps, leg.variant, tiles)
    if leg.kernel == "mix":
        return mix(reps, kw, c)
    return selmix(reps, kw, c, leg.variant)


def run_plain(leg: Leg, reps: int, kw=None, c=None, x=None, tiles=1):
    if leg.kernel == "issue":
        return issue_reference(x, reps, leg.variant, tiles)
    if leg.kernel == "mix":
        return mix_reference(reps, kw, c)
    return selmix_reference(reps, kw, c, leg.variant)


# -- SASS of the built kernels ------------------------------------------------

# "/*0150*/  @!P0 BRA 0x90 ;": address, predicate, opcode, operands
_INSN = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_PRED = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+@!?(U?P\w+)\s")
# 4-byte words that one thread's LDS, STS or ATOMS moves, by its width
_WORDS = {"U8": 0.25, "S8": 0.25, "U16": 0.5, "S16": 0.5, "64": 2, "128": 4}


def _weights(op: str) -> dict:
    """One instruction's share of each pipe: roofline's "alu", "fma" and
    "issue" (every instruction), and the shared-memory words it moves (a
    shared atomic its word)."""
    base, *mods = op.split(".")
    return {"issue": 1, "alu": int(base in roofline.ALU_OPS),
            "fma": int(base in roofline.FMA_OPS),
            "shared": _WORDS.get(next((m for m in mods if m in _WORDS),
                                      None), 1)
            if base in ("LDS", "STS", "ATOMS") else 0}


def _target(args: str) -> int | None:
    m = re.findall(r"0x([0-9a-f]+)", args)
    return int(m[-1], 16) if m else None


def _inner_loop(insns):
    """Opcode counts of a function's largest innermost loop (the span from
    a backward branch's target to the branch), and its instructions by
    pipe (roofline's "alu", "fma", "issue": all) and shared words."""
    loops = []
    for addr, op, args, *_ in insns:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [lo for lo in loops
             if not any(o != lo and lo[0] <= o[0] and o[1] <= lo[1]
                        for o in loops)]
    if not inner:
        raise RuntimeError("no loop found in the kernel's SASS")
    lo, hi = max(inner, key=lambda s: s[1] - s[0])
    counts = {k: 0 for k in SASS_OPS}
    pipes = {"issue": 0, "alu": 0, "fma": 0, "shared": 0}
    for addr, op, *_ in insns:
        if lo <= addr <= hi:
            base = op.split(".")[0]
            if base in counts:
                counts[base] += 1
            for k, v in _weights(op).items():
                pipes[k] += v
    counts["total"] = pipes["issue"]
    return counts, pipes


def loop_spans(insns) -> dict:
    """{head address: address of the last branch back to it}: the
    function's loops, a loop being every backward branch to one head."""
    spans = {}
    for addr, op, args, *_ in insns:
        t = _target(args)
        if op.startswith("BRA") and t is not None and t <= addr:
            spans[t] = max(spans.get(t, addr), addr)
    return spans


def trip_min(insns, head: int, through: str | None = None) -> dict:
    """The least that one trip of the loop at `head` can take, by pipe
    (``_weights``): the shortest path over the loop's instructions from
    the head to a branch back to it, along fall-throughs and branches
    inside the loop. The instructions of loops nested in it count nothing
    (their trips count apart). With `through`, an opcode prefix, the path
    passes an instruction of that opcode (a trip that does some work). A
    lower bound on any trip, whatever the data: a path skipped by a
    branch is never counted."""
    hi = loop_spans(insns)[head]
    span = [i for i in insns if head <= i[0] <= hi]
    at = {ins[0]: k for k, ins in enumerate(span)}
    nested = [(h, e) for h, e in loop_spans(insns).items()
              if head < h and e <= hi]
    succ, ends = [], set()
    for k, (addr, op, args, *rest) in enumerate(span):
        pred = bool(rest and rest[0])
        base = op.split(".")[0]
        nxt = [k + 1] if k + 1 < len(span) else []
        if base == "BRA":
            t = _target(args)
            if t == head:
                ends.add(k)
                out = []
            else:
                out = [at[t]] if t in at else []
            out += nxt if pred else []
        elif base in ("EXIT", "RET", "BRX", "JMX", "JMP"):
            out = nxt if pred else []
        else:
            out = nxt
        succ.append(out)
    if not ends:
        raise RuntimeError(f"the loop at {head:#x} has no branch back")
    pred_of = [[] for _ in span]
    for k, out in enumerate(succ):
        for v in out:
            pred_of[v].append(k)
    hits = [k for k, ins in enumerate(span)
            if through is None or ins[1].startswith(through)]
    if not hits:
        raise RuntimeError(f"no {through} in the loop at {head:#x}")
    res = {}
    for pipe in ("issue", "alu", "fma", "shared"):
        w = [0 if any(h <= ins[0] <= e for h, e in nested)
             else _weights(ins[1])[pipe] for ins in span]
        fwd = _dijkstra(w, succ, [0])
        back = _dijkstra(w, pred_of, sorted(ends))
        res[pipe] = min(fwd[k] + back[k] - w[k] for k in hits)
        if res[pipe] == float("inf"):
            raise RuntimeError(f"no trip of the loop at {head:#x} passes "
                               f"{through}")
    return res


def _dijkstra(w, succ, sources) -> list:
    """Least node-weighted path lengths from any of `sources`, sources'
    weights included."""
    dist = [float("inf")] * len(w)
    heap = []
    for s in sources:
        dist[s] = w[s]
        heap.append((w[s], s))
    heapq.heapify(heap)
    while heap:
        d, k = heapq.heappop(heap)
        if d > dist[k]:
            continue
        for v in succ[k]:
            if d + w[v] < dist[v]:
                dist[v] = d + w[v]
                heapq.heappush(heap, (dist[v], v))
    return dist


def sass_functions() -> dict:
    """{function name: [(address, opcode, operands, predicated)]} from
    ``cuobjdump -sass`` of the kernel library, built first if this source
    hash has none (an @PT predicate counts as none)."""
    _build.load()
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_build.lib_path())],
                          capture_output=True, text=True, check=True).stdout
    funcs = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _INSN.match(line)
        if m and name is not None:
            p = _PRED.match(line)
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3),
                                bool(p) and p.group(1) != "PT"))
    return funcs


def sass_loops() -> dict:
    """{variant: inner-loop opcode counts, and "per_elem", the loop's
    instructions for one element by pipe ("alu", "fma", "issue") and its
    shared-memory words ("shared"); an element is one thread-rep of the
    8 chains for the issue kernels, one step for sel_b4} from
    ``cuobjdump -sass`` of the library, built first if this source hash
    has none."""
    funcs = sass_functions()
    out = {}
    for variant, sym in SYMBOLS.items():
        if sym not in funcs:
            raise RuntimeError(f"{sym} not in the SASS of the library")
        counts, pipes = _inner_loop(funcs[sym])
        # elements in one pass of the loop: the stores of c (loads for the
        # sweep; 4 steps a store for sel_b4, whose rate counts steps), or
        # for the issue kernels the reps it unrolls
        units = {"addxor": counts["LOP3"] // CHAINS,
                 "cmpsel": counts["ISETP"] // CHAINS,
                 "sel_b4": counts["STS"] * 4,
                 "sweeponly": counts["LDS"]}.get(variant, counts["STS"])
        if units < 1:
            raise RuntimeError(f"{sym}: cannot count the elements of its "
                               f"inner loop {counts}")
        counts["per_elem"] = {k: v / units for k, v in pipes.items()}
        out[variant] = counts
    return out


# -- timing -------------------------------------------------------------------

def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _clock_under_load(fn, ms: float) -> str:
    """The SM clock and power draw as nvidia-smi reads them while about
    half a second of fn's launches (ms each) keeps the card busy."""
    for _ in range(math.ceil(500 / max(ms, 1e-3))):
        fn()
    smi = roofline.smi("clocks.sm,power.draw")
    torch.cuda.synchronize()
    return smi


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def run_legs(device="cuda", prefix: str = "") -> dict:
    """Every leg on the card: checked, timed and printed (each line starts
    with `prefix`). Returns {"card", "legs": {tag: record}, "kernels":
    {kernel: the kernels-line entry of its NAMED leg, without launches}}.
    Raises at the first check that fails; never falls back to the CPU."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the microbenchmark measures a CUDA card")
    gpu = roofline.card(dev)
    sms = gpu.sms
    sass = sass_loops()
    legs, kernels = {}, {}
    errs = {"issue": 0, "mix": 0, "selmix": 0}

    def equal(leg, got, want, what):
        err = _err(got, want)
        errs[leg.kernel] = max(errs[leg.kernel], err)
        _require(err == 0 and torch.equal(got, want),
                 f"{leg.tag} {what}: kernel equals its plain version")

    def bounded(leg, tag, ms, elems, nbytes):
        """The leg's bound (roofline.pipe_bound of its SASS), which its
        time must not beat."""
        b = roofline.pipe_bound(gpu, sass[leg.variant]["per_elem"], elems,
                                nbytes)
        _require(ms >= b[0], f"{tag}: {ms:.4f} ms is no less than its "
                 f"bound {b[0]:.4f} ms ({b[2]})")
        return b

    def timed(leg, tag, args, elems, nbytes, extra):
        fn = lambda: run_kernel(leg, leg.reps, **args)  # noqa: E731
        out = fn()
        runs = [_event_ms(fn) for _ in range(5)]
        ms = statistics.median(runs)
        under_load = _clock_under_load(fn, ms)
        ops = leg.ops_per_elem * elems
        s = sass[leg.variant]
        bound_ms, bound_by, pipe = bounded(leg, tag, ms, elems, nbytes)
        shares = {k: v / ms for k, v in roofline.pipe_ms(
            gpu, s["per_elem"], elems, nbytes).items()}
        rec = {"card": gpu.name, "kernel": leg.kernel,
               "variant": leg.variant, "reps": leg.reps, "wall_ms": ms,
               "runs_ms": runs, "Top_s": ops / ms / 1e9,
               "Top_s_sass": s["per_elem"]["issue"] * elems / ms / 1e9,
               "elem_G_s": elems / ms / 1e6,
               "ops_per_elem": leg.ops_per_elem,
               "sass_per_elem": s["per_elem"],
               "sass_loop": {k: v for k, v in s.items() if k != "per_elem"},
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_pipe": pipe, "pipe_share": shares,
               "clock_power_under_load": under_load, "checksum": "ok",
               **extra}
        legs[tag] = rec
        print(f"{prefix}{tag}: {ms:.4f} ms (median of 5); "
              f"{rec['Top_s']:.3f} Top/s by source ops "
              f"({leg.ops_per_elem} an element), {rec['Top_s_sass']:.3f} by "
              f"SASS ({s['per_elem']['issue']:.2f} an element); "
              f"{rec['elem_G_s']:.2f} G elements/s; bound {bound_ms:.4f} ms "
              f"({pipe}); share of each pipe's rate "
              + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
              + f"; {json.dumps(extra)}; SM clock, power under load "
              f"{under_load}; SASS loop {json.dumps(rec['sass_loop'])}",
              flush=True)
        return out

    for leg in LEGS:
        if leg.kernel == "issue":
            tiles = ISSUE_TILES_PER_SM * sms
            x = issue_input(dev)
            for reps in (CHECK_REPS, ISSUE_CHECK_REPS):
                args = dict(x=x, tiles=tiles)
                if leg.tag == NAMED["issue"] and reps == ISSUE_CHECK_REPS:
                    got, want, k_ms, p_ms = _in_turns(leg, reps, args)
                    kernels["issue"] = _entry(leg, k_ms, p_ms, bounded(
                        leg, leg.tag, k_ms, reps * tiles * 1024,
                        x.numel() * 4 + tiles * 1024 * 4))
                else:
                    got = run_kernel(leg, reps, **args)
                    want = run_plain(leg, reps, **args)
                equal(leg, got, want, f"reps {reps}, {tiles} tiles")
            out = timed(leg, leg.tag, dict(x=x, tiles=tiles),
                        leg.reps * tiles * 1024,
                        x.numel() * 4 + tiles * 1024 * 4, {"tiles": tiles})
            _require(bool((out == out[0]).all()),
                     f"{leg.tag}: every tile equal at reps {leg.reps}")
            continue
        steps = 4 if leg.variant == "sel_b4" else 1
        for tag, shape in ((leg.tag, leg.shape),
                           (leg.tag + "@card", card_shape(leg.shape, sms))):
            kw_h, c_h, kw, c = mix_input(shape, dev)
            args = dict(kw=kw, c=c)
            got = run_kernel(leg, CHECK_REPS, **args)
            equal(leg, got, run_plain(leg, CHECK_REPS, **args),
                  f"{shape} reps {CHECK_REPS}")
            replay = (_mix_replay(kw_h, c_h, CHECK_REPS)
                      if leg.kernel == "mix"
                      else _sel_replay(kw_h, c_h, CHECK_REPS, leg.variant))
            _require(checksum(got) == replay,
                     f"{tag}: checksum {checksum(got)} equals the replay's "
                     f"{replay}")
            elems = leg.reps * kw.numel() * steps
            # c (and kw, but for the sweep) read once, the output written
            nbytes = ((1 if leg.variant == "sweeponly" else 2) * kw.numel()
                      + kw[0].numel()) * 4
            if tag == leg.tag:
                # the TPU's shape at the timed reps, against the plain
                # version (in turns for the named leg)
                if NAMED[leg.kernel] == leg.tag:
                    got, want, k_ms, p_ms = _in_turns(leg, leg.reps, args)
                    kernels[leg.kernel] = _entry(leg, k_ms, p_ms, bounded(
                        leg, leg.tag, k_ms, elems, nbytes))
                else:
                    got = run_kernel(leg, leg.reps, **args)
                    want = run_plain(leg, leg.reps, **args)
                equal(leg, got, want, f"{shape} reps {leg.reps}")
            rpb = rows_per_block(shape[0], sms)
            timed(leg, tag, args, elems, nbytes,
                  {"shape": list(shape), "rows_per_block": rpb,
                   "blocks": -(-shape[0] // rpb)})
            del kw, c, args
    for name, entry in kernels.items():
        entry["max_abs_err"] = errs[name]
    return {"card": gpu.name, "peaks_per_s": _peaks(gpu), "legs": legs,
            "kernels": kernels}


def _peaks(gpu) -> dict:
    """The card's rates that the bounds divide by."""
    return {"memory_bytes": roofline.HBM_BYTES_PER_S,
            "alu": gpu.per_s(roofline.ALU_LANES_PER_SM),
            "fma": gpu.per_s(roofline.FMA_LANES_PER_SM),
            "issue": gpu.per_s(roofline.ISSUE_LANES_PER_SM),
            "shared_words": gpu.per_s(roofline.SHARED_WORDS_PER_SM)}


def _in_turns(leg, reps, args):
    """Kernel and plain version in turns after a warm-up of each, median
    of 5 CUDA-event times; returns both outputs and both medians."""
    out = {}

    def kernel():
        out["k"] = run_kernel(leg, reps, **args)

    def plain():
        out["p"] = run_plain(leg, reps, **args)

    kernel()
    plain()
    ks, ps = [], []
    for _ in range(5):
        ks.append(_event_ms(kernel))
        ps.append(_event_ms(plain))
    return out["k"], out["p"], statistics.median(ks), statistics.median(ps)


def _entry(leg, ms, plain_ms, bound) -> dict:
    """A kernels-line entry (chip_smoke.py adds the launches): the leg's
    times beside its bound, (ms, "bytes" or "operations", pipe) from
    roofline.pipe_bound."""
    return {"name": leg.kernel, "route": "cuda",
            "source": "qvz_tpu_torch/csrc/microbench.cu",
            "replaces": f"scripts/vpu_microbench.py:{SOURCES[leg.kernel]}",
            "leg": leg.tag, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "bound_pipe": bound[2], "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench: no CUDA device is visible", file=sys.stderr)
        return 1
    t = time.perf_counter()
    res = run_legs("cuda")
    record = {"ts": time.time(), "card": res["card"],
              "device": torch.cuda.get_device_name(0),
              "peaks_per_s": res["peaks_per_s"],
              "seconds": time.perf_counter() - t, "legs": res["legs"],
              "kernels": res["kernels"]}
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(record, indent=1))
    print(f"wrote {OUT} ({len(res['legs'])} legs, {res['card']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
