"""The codebook design of QVZ (src/codebook.c, src/quantizer.c,
src/pmf.c) in plain NumPy, to the last bit of every double.

Every sum runs in the C reference's order, one term after another, as
an array operation over many contexts at once; no reduction that could
reorder the terms (np.sum pairs them) is used on a double. Entropies go
through ``math.log2``, which is the C library's log2, as the reference
calls it. ``dtype`` is float64, as the reference; the lower precision
(float32) is the benchmark's control.

One column of one cluster depends on the previous column's design, so
the columns run in order, all clusters side by side. Inside a column
each context's state-count sweep (codebook.c:230-269) is independent:
they run as batches of Lloyd-Max designs (quantizer.c:34-132), several
state counts of a context in one batch, and the sweep's rule is then
replayed in order, so a count past the stop is never consulted.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

A = 72                  # the alphabet
MAX_ITER = 100          # Lloyd-Max iterations
MODE_RATIO = 0


def mse_matrix(dtype=np.float64) -> np.ndarray:
    """dist[i][r] = (i - r)^2, the MSE distortion (distortion.c)."""
    i = np.arange(A, dtype=np.float64)
    return ((i[:, None] - i[None, :]) ** 2).astype(dtype)


@dataclass
class Quant:
    q: np.ndarray               # (72,) uint8 map
    out: list                   # the reconstruction points, as designed


@dataclass
class ColumnBook:
    contexts: list              # the context alphabet (duplicates kept)
    lo: list = field(default_factory=list)
    hi: list = field(default_factory=list)
    ratio: list = field(default_factory=list)
    qratio: list = field(default_factory=list)

    @property
    def lo_ratio(self) -> list:
        return self.ratio

    @property
    def hi_ratio(self) -> list:
        return [type(r)(1.0) - r for r in self.ratio]


def _log2_terms(p: np.ndarray) -> np.ndarray:
    """p * log2(p) where p > 0, else 0, each log2 from the C library."""
    out = np.zeros_like(p)
    nz = np.nonzero(p > 0)
    vals = p[nz]
    out[nz] = vals * np.array([math.log2(v) for v in vals.tolist()],
                              dtype=p.dtype)
    return out


def _entropy(p: np.ndarray) -> np.ndarray:
    """Row entropies, terms subtracted in ascending index (pmf.c:141)."""
    t = _log2_terms(p)
    h = np.zeros(p.shape[:-1], dtype=p.dtype)
    for i in range(p.shape[-1]):
        h = h - t[..., i]
    return h


def _pmf(counts: np.ndarray, dtype) -> np.ndarray:
    """counts / total over the last axis; an all-zero row stays zero."""
    tot = counts.sum(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = counts.astype(np.float64).astype(dtype) / \
            tot.astype(np.float64).astype(dtype)
    return np.where(tot == 0, dtype(0.0), p).astype(dtype)


def _renormalize(p: np.ndarray) -> np.ndarray:
    tot = np.zeros(p.shape[:-1], dtype=p.dtype)
    for i in range(p.shape[-1]):
        tot = tot + p[..., i]
    with np.errstate(invalid="ignore", divide="ignore"):
        q = p / tot[..., None]
    return np.where((tot > 0)[..., None], q, p)


def lloyd_max(pmf: np.ndarray, states: np.ndarray, dist: np.ndarray):
    """Lloyd-Max designs of B rows: pmf (B, 72), states (B,). Returns the
    maps (B, 72) int64 and the reconstruction points (B, 72) int64 (the
    first states[b] are row b's)."""
    b_n = pmf.shape[0]
    s_max = int(states.max())
    jj = np.arange(s_max + 1)
    bounds = np.where(jj[None, :] < states[:, None],
                      (jj[None, :] * A) // states[:, None], A)
    rec = np.zeros((b_n, s_max), dtype=np.int64)
    valid = jj[None, :s_max] < states[:, None]
    rec[:] = np.where(valid, (bounds[:, :-1] + bounds[:, 1:] - 1) // 2, 0)
    # pd[b, i, r] = pmf[b, i] * dist[i][r], the reference's term. A term
    # whose pmf is 0 adds +0.0 to a sum that is never negative, which
    # leaves it as it is: each row keeps only the terms of its nonzero
    # symbols, in ascending order. pdz[b, r, k] is the term of row b's
    # k-th nonzero symbol (0 past the last); nz_before[b, i] counts the
    # nonzero symbols below i.
    nz = pmf > 0
    nnz = nz.sum(axis=1)
    k_n = int(nnz.max()) + 1
    order = np.argsort(~nz, axis=1, kind="stable")[:, :k_n]
    keep = np.arange(k_n)[None, :] < nnz[:, None]
    p_k = np.where(keep, np.take_along_axis(pmf, order, axis=1), 0.0)
    pdz_flat = np.zeros(b_n * A * k_n + 1, dtype=pmf.dtype)
    pdz_flat[:-1].reshape(b_n, A, k_n)[:] = \
        p_k[:, None, :] * dist[order].transpose(0, 2, 1)
    zslot = pdz_flat.size - 1
    nz_before = np.concatenate([np.zeros((b_n, 1), dtype=np.int64),
                                np.cumsum(nz, axis=1)], axis=1)
    r_idx = np.arange(A)
    # better[j, a, c]: the walk moves from point a to point c at j
    # (quantizer.c:93-107: dist[j][c] < dist[j][a], 1 <= j <= 70)
    better = dist[:, None, :] < dist[:, :, None]
    better[0] = False
    better[A - 1] = False
    active = np.ones(b_n, dtype=bool)
    scalar = np.zeros(b_n, dtype=bool)
    for _ in range(MAX_ITER):
        rows = np.nonzero(active & ~scalar)[0]
        if len(rows) == 0:
            break
        bd = bounds[rows]
        st = states[rows]
        mono = np.all(np.diff(bd, axis=1) >= 0, axis=1)
        if not mono.all():
            scalar[rows[~mono]] = True
            rows, bd, st = rows[mono], bd[mono], st[mono]
            if len(rows) == 0:
                continue
        n = len(rows)
        # the region j of each candidate r: bounds[j] <= r < bounds[j+1]
        inner = jj[None, 1:s_max] < st[:, None]
        at = (np.arange(n)[:, None] * (A + 1) + bd[:, 1:s_max])[inner]
        reg = np.cumsum(np.bincount(at, minlength=n * (A + 1))
                        .reshape(n, A + 1)[:, :A], axis=1)
        bdf = bd.reshape(-1)
        roff = (np.arange(n) * (s_max + 1))[:, None]
        lo = bdf[roff + reg]
        hi = bdf[roff + reg + 1]
        nzb = nz_before[rows].reshape(-1)
        noff = (np.arange(n) * (A + 1))[:, None]
        klo = nzb[noff + lo]
        length = nzb[noff + hi] - klo
        mse = np.zeros((n, A), dtype=pmf.dtype)
        # flat index of pdz[row, r, klo + d]; a term past its region
        # reads the zero at the end of pdz_flat
        idx = (rows * (A * k_n))[:, None] + r_idx[None, :] * k_n + klo
        for d in range(int(length.max(initial=0))):
            mse += pdz_flat[np.where(d < length, idx, zslot)]
            idx += 1
        # first minimum of each region, strict < from DBL_MAX: the least
        # value of each run of candidates, then the first r that has it;
        # an empty region keeps bounds[j]
        start = np.ones((n, A), dtype=bool)
        start[:, 1:] = reg[:, 1:] != reg[:, :-1]
        starts = np.flatnonzero(start)
        flat = mse.reshape(-1)
        seg = np.cumsum(start.reshape(-1)) - 1
        least = np.minimum.reduceat(flat, starts)
        first = np.minimum.reduceat(
            np.where(flat == least[seg], np.tile(r_idx, n), A), starts)
        new_rec = bd[:, :s_max].copy()
        new_rec[starts // A, reg.reshape(-1)[starts]] = first
        new_rec = np.where(jj[None, :s_max] < st[:, None], new_rec, 0)
        changed = np.any(new_rec != rec[rows], axis=1)
        rec[rows] = new_rec
        # the bounds walk (quantizer.c:93-107). The pointer moves from
        # point a to point c > a at the first j >= j0 with (j - c)^2 <
        # (j - a)^2, j > (a + c) / 2: jf_r = max(jf_{r-1} + 1, m_r), a
        # running maximum of m_r - r. Rows whose points do not rise walk
        # one pair at a time.
        bd = bd.copy()
        steady = np.all((new_rec[:, 1:] > new_rec[:, :-1])
                        | (jj[None, 1:s_max] >= st[:, None]), axis=1)
        if s_max > 1:
            m = (new_rec[:, :-1] + new_rec[:, 1:]) // 2 + 1
            m[:, 0] = np.maximum(m[:, 0], 1)
            jf = np.maximum.accumulate(m - jj[None, :s_max - 1], axis=1) \
                + jj[None, :s_max - 1]
            moved = np.logical_and.accumulate(jf <= A - 2, axis=1) & \
                (jj[None, :s_max - 1] < (st - 1)[:, None]) & steady[:, None]
            bd[:, 1:s_max] = np.where(moved, jf, bd[:, 1:s_max])
        for b in np.nonzero(~steady)[0]:
            r, j = 0, 1
            while j < A - 1 and r < st[b] - 1:
                if better[j, new_rec[b, r], new_rec[b, r + 1]]:
                    r += 1
                    bd[b, r] = j
                j += 1
        bounds[rows] = bd
        active[rows] = changed
    maps = np.zeros((b_n, A), dtype=np.int64)
    for j in range(s_max):
        lo = bounds[:, j][:, None]
        hi = bounds[:, j + 1][:, None]
        inside = (r_idx[None, :] >= lo) & (r_idx[None, :] < hi) & \
            (j < states)[:, None]
        maps = np.where(inside, rec[:, j][:, None], maps)
    for b in np.nonzero(scalar)[0]:
        maps[b], rec[b, :states[b]] = _lloyd_scalar(
            pmf[b].tolist(), int(states[b]), dist)
    return maps, rec


def _lloyd_scalar(pmf: list, states: int, dist: np.ndarray):
    """One Lloyd-Max design, line for line as quantizer.c (the path for
    bounds that a walk left out of order)."""
    d = dist.tolist()
    bounds = [0] * (states + 1)
    bounds[states] = A
    for j in range(1, states):
        bounds[j] = (j * A) // states
    rec = [(bounds[j] + bounds[j + 1] - 1) // 2 for j in range(states)]
    changed, it = True, 0
    dt = dist.dtype.type
    while changed and it < MAX_ITER:
        changed = False
        it += 1
        for j in range(states):
            min_mse, min_r = math.inf, bounds[j]
            for r in range(bounds[j], bounds[j + 1]):
                mse = dt(0.0)
                for i in range(bounds[j], bounds[j + 1]):
                    mse = dt(mse + dt(dt(pmf[i]) * dt(d[i][r])))
                if mse < min_mse:
                    min_r, min_mse = r, mse
            if min_r != rec[j]:
                changed = True
                rec[j] = min_r
        r, j = 0, 1
        while j < A - 1 and r < states - 1:
            if d[j][rec[r + 1]] < d[j][rec[r]]:
                r += 1
                bounds[r] = j
            j += 1
    q = [0] * A
    for j in range(states):
        for i in range(bounds[j], bounds[j + 1]):
            q[i] = rec[j]
    return np.array(q, dtype=np.int64), np.array(rec, dtype=np.int64)


def _quantized_entropy(maps: np.ndarray, pmf: np.ndarray) -> np.ndarray:
    """Entropy of each row's quantized pmf (quantizer.c:139-161)."""
    out = np.zeros_like(pmf)
    rows = np.arange(pmf.shape[0])
    for i in range(A):
        out[rows, maps[:, i]] = out[rows, maps[:, i]] + pmf[:, i]
    return _entropy(out)


def sweep(pmf: np.ndarray, target: np.ndarray, dist: np.ndarray):
    """The state-count sweep of each row (codebook.c:230-269). Returns
    per row (lo Quant, hi Quant, ratio). Each wave designs several state
    counts of every unfinished row; the reference's rule then reads them
    in ascending order and ignores any past its stop."""
    t_n = pmf.shape[0]
    dt = pmf.dtype.type
    result: list = [None] * t_n
    last: list = [None] * t_n
    s_last = {t: 0 for t in range(t_n)}
    live = list(range(t_n))
    width = 12
    while live:
        rows, st = [], []
        for t in live:
            top = 1 if target[t] == 0.0 else min(A, s_last[t] + width)
            for s in range(s_last[t] + 1, top + 1):
                rows.append(t)
                st.append(s)
        rows_a = np.array(rows)
        maps, rec = lloyd_max(pmf[rows_a], np.array(st, dtype=np.int64),
                              dist)
        h = _quantized_entropy(maps, pmf[rows_a])
        still = []
        k = 0
        for t in live:
            while k < len(rows) and rows[k] == t:
                s = st[k]
                cand = (maps[k], rec[k, :s], h[k])
                k += 1
                if result[t] is not None:
                    continue
                if s == 1:
                    if target[t] == 0.0:
                        q = Quant(cand[0].astype(np.uint8), cand[1].tolist())
                        result[t] = (q, q, dt(1.0))
                    else:
                        last[t] = cand
                        s_last[t] = s
                elif not (cand[2] < target[t] and s < A):
                    lo_m, lo_r, lo_h = last[t]
                    hi_h = cand[2]
                    if hi_h < target[t]:
                        ratio = dt(0.0)
                    elif lo_h >= target[t] or hi_h == lo_h:
                        ratio = dt(1.0)
                    else:
                        ratio = dt((target[t] - hi_h) / (lo_h - hi_h))
                    result[t] = (Quant(lo_m.astype(np.uint8), lo_r.tolist()),
                                 Quant(cand[0].astype(np.uint8),
                                       cand[1].tolist()), ratio)
                else:
                    last[t] = cand
                    s_last[t] = s
            if result[t] is None:
                still.append(t)
        live = still
        width = max(4, min(16, 256 // max(1, len(live))))
    return result


def _merge_union(a: list, b: list) -> list:
    """Sorted merge that drops a duplicate only where both heads are
    equal (pmf.c:312-357)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        if a[i] < b[j]:
            out.append(a[i])
            i += 1
        elif a[i] == b[j]:
            out.append(a[i])
            i += 1
            j += 1
        else:
            out.append(b[j])
            j += 1
    return out + a[i:] + b[j:]


def design(counts0: np.ndarray, cond: np.ndarray, ratio_opt: float,
           mode: int = MODE_RATIO, dtype=np.float64) -> list:
    """Per cluster, the list of ColumnBook of every column."""
    dt = np.dtype(dtype).type
    k_n, cols1 = cond.shape[0], cond.shape[1]
    cols = cols1 + 1
    dist = mse_matrix(dtype)
    ratio_opt = dt(ratio_opt)
    cond_p = _pmf(cond, dt)                      # (K, cols-1, A, A)
    # marginals (codebook.c:208-218): acc = 1.0 * acc + w_j * P(.|j)
    marg = np.zeros((k_n, cols, A), dtype=dtype)
    marg[:, 0] = _pmf(counts0, dt)
    for c in range(1, cols):
        acc = np.zeros((k_n, A), dtype=dtype)
        for j in range(A):
            acc = dt(1.0) * acc + marg[:, c - 1, j][:, None] * \
                cond_p[:, c - 1, j]
        marg[:, c] = acc
    books = [[None] * cols for _ in range(k_n)]

    def targets(p):
        h = _entropy(p)
        return h * ratio_opt if mode == MODE_RATIO else \
            np.full(len(p), ratio_opt, dtype=dtype)

    pmf0 = _pmf(counts0, dt)
    res = sweep(pmf0, targets(pmf0), dist)
    for k in range(k_n):
        lo, hi, r = res[k]
        books[k][0] = ColumnBook([0], [lo], [hi], [r], [_qratio(r)])
    prev_qpmf = [None] * k_n
    for c in range(1, cols):
        unions, xpmfs = [], []
        for k in range(k_n):
            prev = books[k][c - 1]
            uni = list(prev.lo[0].out)
            inter = [q for j in range(len(prev.contexts))
                     for q in (prev.lo[j], prev.hi[j])]
            for q in inter[1:]:
                uni = _merge_union(uni, q.out)
            usym = np.array(uni, dtype=np.int64)
            if c == 1:
                r0 = prev.ratio[0]
                lo_m = prev.lo[0].q.astype(np.int64)[:, None] == usym[None]
                hi_m = prev.hi[0].q.astype(np.int64)[:, None] == usym[None]
                qpmf = np.where(lo_m, dt(0.0) + r0, dt(0.0))
                qpmf = np.where(hi_m, qpmf + (dt(1.0) - r0), qpmf)
            else:
                cp = cond_p[k, c - 2]
                m2 = marg[k, c - 2]
                pq = prev_qpmf[k]                      # (A, prev_n)
                pt = np.zeros((pq.shape[1], A), dtype=dtype)
                for x in range(A):
                    pt = pt + (pq[x][:, None] * cp[x][None, :]) * m2[x]
                qpmf = np.zeros((A, len(uni)), dtype=dtype)
                lo_r, hi_r = prev.lo_ratio, prev.hi_ratio
                for j in range(len(prev.contexts)):
                    lo_m = prev.lo[j].q.astype(np.int64)[:, None] == \
                        usym[None]
                    hi_m = prev.hi[j].q.astype(np.int64)[:, None] == \
                        usym[None]
                    pqx = np.where(lo_m, dt(0.0) + lo_r[j], dt(0.0))
                    pqx = np.where(hi_m, pqx + hi_r[j], pqx)
                    qpmf = qpmf + pqx * pt[j][:, None]
                qpmf = _renormalize(qpmf)
            cpx = cond_p[k, c - 1]
            m1 = marg[k, c - 1]
            xp = np.zeros((len(uni), A), dtype=dtype)
            for x in range(A):
                xp = xp + (qpmf[x][:, None] * cpx[x][None, :]) * m1[x]
            xpmfs.append(_renormalize(xp))
            unions.append(uni)
            prev_qpmf[k] = qpmf
        allx = np.concatenate(xpmfs)
        res = sweep(allx, targets(allx), dist)
        pos = 0
        for k in range(k_n):
            n_ctx = len(unions[k])
            book = ColumnBook(unions[k])
            for lo, hi, r in res[pos:pos + n_ctx]:
                book.lo.append(lo)
                book.hi.append(hi)
                book.ratio.append(r)
                book.qratio.append(_qratio(r))
            pos += n_ctx
            books[k][c] = book
    return books


def _qratio(r) -> int:
    return int(r * 128.0) & 0xFF


def serialize(books: list) -> bytes:
    """The codebook blocks of every cluster (codebook.c:474-555)."""
    out = bytearray()
    for cluster in books:
        b0 = cluster[0]
        out += bytes([b0.qratio[0] + 33, 10])
        out += (b0.lo[0].q + 33).tobytes() + b"\n"
        out += (b0.hi[0].q + 33).tobytes() + b"\n"
        for b in cluster[1:]:
            out += bytes(q + 33 for q in b.qratio) + b"\n"
            out += b"".join((q.q + 33).tobytes() for q in b.lo) + b"\n"
            out += b"".join((q.q + 33).tobytes() for q in b.hi) + b"\n"
    return bytes(out)
