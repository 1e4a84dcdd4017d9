"""The adaptive arithmetic coder of QVZ in plain NumPy and Python.

The coder (src/arith.c, m = 22 bits) narrows an interval [l, u] by each
symbol's cumulative counts in its adaptive model (src/qv_stream.c:9-61:
counts start at 1, each coded symbol adds 8, and a total past 2^19
halves every count, c -> c // 2 + 1). A symbol's (cum_lo, cum_hi, total)
depends only on the earlier symbols of its model, so the triples of a
stream are worked out first (``triples``), model by model, and the
interval chain runs over them afterwards: ``chain`` for many streams side
by side, one step of every stream at a time, and ``chain_one`` for a
single long stream.

The renormalisation emits the shared leading bits of l and u (E1/E2),
each time after the first with the pending complements of the E3 steps,
and counts E3 steps (l = 01..., u = 10...) as pending (arith.c:52-96).
The stream ends with the leading bit of l, the pending complements, the
21 other bits of l and a zero padding to the next byte that is a whole
byte when the bits end on a byte boundary (os_stream.c:105-110).
"""

from __future__ import annotations

import functools

import numpy as np

M = 22
FULL = (1 << M) - 1
HALF_MASK = (1 << (M - 1)) - 1          # all but the leading bit
MSB = 1 << (M - 1)
R = 1 << (M - 3)                        # the rescale bound
STEP = 8


def _seen(x: np.ndarray, g: np.ndarray) -> tuple:
    """For each symbol x[k] of a run of groups g (contiguous, in coding
    order): how many earlier symbols of its group equal it, and how many
    are smaller. One-hot counts over the symbols a group uses, the groups
    bucketed by their largest symbol so the width stays small."""
    n = len(x)
    at_x = np.zeros(n, dtype=np.int64)
    below = np.zeros(n, dtype=np.int64)
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    sizes = np.diff(np.r_[starts, n])
    top = np.repeat(np.maximum.reduceat(x, starts), sizes)
    lo_w = 0
    for width in (2, 4, 8, 16, 32, 64, 128):
        sel = np.flatnonzero((top >= lo_w) & (top < width))
        lo_w = width
        if len(sel) == 0:
            continue
        xs, gs = x[sel], g[sel]
        k = np.arange(len(sel))
        st = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
        seen = (xs[:, None] == np.arange(width)[None, :]).astype(np.int32)
        np.cumsum(seen, axis=0, out=seen)
        seen[k, xs] -= 1
        seen -= np.repeat(seen[st], np.diff(np.r_[st, len(sel)]), axis=0)
        at_x[sel] = seen[k, xs]
        np.cumsum(seen, axis=1, out=seen)
        below[sel] = seen[k, xs] - at_x[sel]
    return at_x, below


def triples(model: np.ndarray, sym: np.ndarray, stream: np.ndarray,
            card: np.ndarray, init_counts, init_total, want_final=False):
    """(cum_lo, cum_hi, total) of each coded symbol, int64 (E,) each.

    model, sym, stream: (E,) the symbols in coding order, with the model
    each is coded in and the stream (lane) it belongs to; a model of one
    stream is independent of the same model in another stream; stream
    never decreases along the input. card: (n_models,) cardinalities.
    init_counts(models) -> (G, w) int64 counts the models start from (0
    past a model's cardinality), init_total(models) -> (G,). With
    want_final, also returns each (stream, model) group's stream, model,
    counts and total after the last of its symbols.
    """
    e_n = len(model)
    # group by (model, stream): stream never falls along the input, so a
    # stable sort by model (a radix sort of dense 16-bit ids) keeps each
    # group's symbols together and in order
    present = np.bincount(model, minlength=len(card)) > 0
    dense = np.cumsum(present) - 1
    order = np.argsort(dense[model].astype(np.uint16), kind="stable")
    m_s = model[order]
    x_s = sym[order].astype(np.int64)
    st_s = stream[order]
    new_group = np.ones(e_n, dtype=bool)
    new_group[1:] = (m_s[1:] != m_s[:-1]) | (st_s[1:] != st_s[:-1])
    g_start = np.flatnonzero(new_group)
    g_id = np.cumsum(new_group) - 1
    g_model = m_s[g_start]
    g_n = len(g_start)
    models = np.flatnonzero(present)
    w = int(card[models].max()) if e_n else 1
    # each group reads its counts from a state row: at first its model's
    # initial counts, after a rescale a row of its own
    s_counts = init_counts(models)[:, :w].astype(np.int64)
    s_total = init_total(models).astype(np.int64)
    g_state = dense[g_model]
    lo = np.empty(e_n, dtype=np.int64)
    hi = np.empty(e_n, dtype=np.int64)
    tot = np.empty(e_n, dtype=np.int64)
    fin_counts = np.zeros((g_n, w), dtype=np.int64) if want_final else None
    fin_total = np.zeros(g_n, dtype=np.int64)
    first = g_start.copy()          # each group's first symbol not coded
    todo = np.arange(e_n)
    # A pass takes every group up to and including the update that
    # rescales it, where total + 8 (t + 1) passes 2^19 at its t-th
    # symbol; the rest of a group that rescaled waits for the next pass.
    while len(todo):
        g = g_id[todo]
        t = todo - first[g]
        t_rescale = np.maximum((R - s_total[g_state]) // STEP, 0)
        now = t <= t_rescale[g]
        e, g, t = todo[now], g[now], t[now]
        x = x_s[e]
        sx = g_state[g]
        at_x, seen_below = _seen(x, g)
        below_tab = np.cumsum(s_counts, axis=1) - s_counts
        lo[e] = below_tab[sx, x] + STEP * seen_below
        hi[e] = lo[e] + s_counts[sx, x] + STEP * at_x
        tot[e] = s_total[sx] + STEP * t
        last = np.r_[np.flatnonzero(g[1:] != g[:-1]), len(e) - 1]
        gl = g[last]
        resc = t[last] == t_rescale[gl]
        more = resc & np.isin(gl, g_id[todo[~now]])
        need = resc | want_final
        if need.any():
            # the counts after each such group's last symbol of the pass
            rows = np.flatnonzero(need)
            pick = np.isin(g, gl[rows])
            slot = np.searchsorted(gl[rows], g[pick])
            after = s_counts[g_state[gl[rows]]].copy()
            np.add.at(after, (slot, x[pick]), STEP)
            halved = np.where(np.arange(w)[None, :]
                              < card[g_model[gl[rows]]][:, None],
                              (after >> 1) + 1, 0)
            r_resc = resc[rows]
            after = np.where(r_resc[:, None], halved, after)
            a_total = np.where(r_resc, halved.sum(axis=1),
                               s_total[g_state[gl[rows]]]
                               + STEP * (t[last][rows] + 1))
            if want_final:
                fin_counts[gl[rows]] = after
                fin_total[gl[rows]] = a_total
            cont = more[rows]
            if cont.any():
                base = len(s_counts)
                s_counts = np.concatenate([s_counts, after[cont]])
                s_total = np.concatenate([s_total, a_total[cont]])
                g_state[gl[rows][cont]] = base + np.arange(int(cont.sum()))
        first[gl] = e[last] + 1
        todo = todo[~now]
    inv = np.empty(e_n, dtype=np.int64)
    inv[order] = np.arange(e_n)
    out = (lo[inv], hi[inv], tot[inv])
    if want_final:
        out += (st_s[g_start], g_model, fin_counts, fin_total)
    return out


@functools.lru_cache(maxsize=1)
def _bitlen_table() -> np.ndarray:
    """Bit lengths of every value under 2^22."""
    return np.frexp(np.arange(1 << M, dtype=np.float64))[1].astype(np.int64)


def chain(lo: np.ndarray, hi: np.ndarray, tot: np.ndarray,
          length: np.ndarray) -> list:
    """The payload of each of S streams from their triples, (T, S) each;
    stream s codes its first length[s] symbols, and its steps past them
    hold (0, 1, 1), which leave the interval as it is."""
    t_n, s_n = lo.shape
    bl = _bitlen_table()
    l = np.zeros(s_n, dtype=np.int64)
    u = np.full(s_n, FULL, dtype=np.int64)
    scale3 = np.zeros(s_n, dtype=np.int64)
    sink = _Sink(s_n)
    m20 = (1 << (M - 2)) - 1
    for t in range(t_n):
        rng = u - l + 1
        u = l + (rng * hi[t]) // tot[t] - 1
        l = l + (rng * lo[t]) // tot[t]
        k1 = np.where((l ^ u) >> (M - 1) == 0, M - bl[l ^ u], 0)
        # E1/E2: the first of the k1 shared bits, scale3 complements of
        # it, the other k1 - 1 bits
        e1 = k1 > 0
        top = l >> (M - k1)
        rest = np.maximum(k1 - 1, 0)
        sink.emit(e1, top >> rest, scale3, top & ((1 << rest) - 1), rest)
        scale3 = np.where(e1, 0, scale3)
        l = (l << k1) & FULL
        u = ((u << k1) | ((1 << k1) - 1)) & FULL
        # E3: the second bits straddle the middle, k3 times in a row
        e3 = ((l >> (M - 2)) == 1) & ((u >> (M - 2)) == 2)
        lrun = (M - 2) - bl[~l & m20]
        zrun = (M - 2) - bl[u & m20]
        k3 = np.where(e3, 1 + np.minimum(lrun, zrun), 0)
        scale3 = scale3 + k3
        l = np.where(e3, (l << k3) & HALF_MASK, l)
        u = np.where(e3, (((u << k3) & HALF_MASK) | MSB) | ((1 << k3) - 1),
                     u)
    # the end: the leading bit of l with its pending complements, then
    # the other 21 bits of l
    sink.emit(np.ones(s_n, dtype=bool), l >> (M - 1), scale3,
              l & HALF_MASK, np.full(s_n, M - 1))
    return sink.payloads()


class _Sink:
    """MSB-first bits of S streams. Each append adds at most 32 bits to
    fewer than 32 pending ones, so it completes at most one 32-bit word
    a stream, kept in a row of its own."""

    def __init__(self, s_n: int):
        self.acc = np.zeros(s_n, dtype=np.int64)
        self.nb = np.zeros(s_n, dtype=np.int64)
        self.words: list = []
        self.full: list = []

    def put(self, val: np.ndarray, n: np.ndarray) -> None:
        acc = (self.acc << n) | val
        nb = self.nb + n
        f = nb >= 32
        sh = np.maximum(nb - 32, 0)
        self.words.append(np.where(f, acc >> sh, 0))
        self.full.append(f)
        self.acc = np.where(f, acc & ((1 << sh) - 1), acc)
        self.nb = np.where(f, sh, nb)

    def emit(self, mask, first, pend, low, n_low) -> None:
        """Where mask: the bit `first`, `pend` copies of its complement,
        then the n_low bits of `low`."""
        n = np.where(mask, 1 + pend + n_low, 0)
        if (n <= 32).all():
            comp = (1 - first) * ((1 << pend) - 1)
            val = (first << (pend + n_low)) | (comp << n_low) | low
            self.put(np.where(mask, val, 0), n)
            return
        self.put(np.where(mask, first, 0), np.where(mask, 1, 0))
        pend = np.where(mask, pend, 0)
        while pend.any():
            k = np.minimum(pend, 31)
            self.put(np.where(first == 0, (1 << k) - 1, 0), k)
            pend = pend - k
        self.put(np.where(mask, low, 0), np.where(mask, n_low, 0))

    def payloads(self) -> list:
        """Each stream's bytes, padded to a byte, plus a zero byte where
        the bits end on a byte boundary (os_stream.c:105-110)."""
        words = np.stack(self.words)
        full = np.stack(self.full)
        out = []
        for s in range(words.shape[1]):
            w = words[:, s][full[:, s]].astype(">u4").tobytes()
            k = int(self.nb[s])
            pad = 8 - k % 8
            out.append(w + (int(self.acc[s]) << pad)
                       .to_bytes((k + pad) // 8, "big"))
        return out


def chain_one(lo, hi, tot) -> bytes:
    """The payload of one stream from its triples (lists or arrays)."""
    l, u, scale3 = 0, FULL, 0
    out = bytearray()
    acc, nb = 0, 0
    for c_lo, c_hi, n in zip(lo.tolist(), hi.tolist(), tot.tolist()):
        if c_lo == 0 and c_hi == n:
            continue
        rng = u - l + 1
        u = l + (rng * c_hi) // n - 1
        l = l + (rng * c_lo) // n
        diff = l ^ u
        if not diff >> (M - 1):
            k1 = M - diff.bit_length()
            top = l >> (M - k1)
            first = top >> (k1 - 1)
            if scale3:
                bits = (first << scale3) | (((1 << scale3) - 1)
                                            if not first else 0)
                acc = (acc << (scale3 + 1)) | bits
                nb += scale3 + 1
                scale3 = 0
            else:
                acc = (acc << 1) | first
                nb += 1
            acc = (acc << (k1 - 1)) | (top & ((1 << (k1 - 1)) - 1))
            nb += k1 - 1
            if nb >= 64:
                rem = nb & 7
                out += (acc >> rem).to_bytes((nb - rem) // 8, "big")
                acc &= (1 << rem) - 1
                nb = rem
            l = (l << k1) & FULL
            u = ((u << k1) | ((1 << k1) - 1)) & FULL
        if (l >> (M - 2)) == 1 and (u >> (M - 2)) == 2:
            v = l & ((1 << (M - 2)) - 1)
            lrun = (M - 2) - (~v & ((1 << (M - 2)) - 1)).bit_length()
            zrun = (M - 2) - (u & ((1 << (M - 2)) - 1)).bit_length()
            k3 = 1 + min(lrun, zrun)
            scale3 += k3
            l = (l << k3) & HALF_MASK
            u = (((u << k3) & HALF_MASK) | MSB) | ((1 << k3) - 1)
    first = l >> (M - 1)
    acc = (acc << (scale3 + 1)) | (first << scale3) | \
        (((1 << scale3) - 1) if not first else 0)
    nb += scale3 + 1
    acc = (acc << (M - 1)) | (l & HALF_MASK)
    nb += M - 1
    pad = 8 - nb % 8
    acc <<= pad
    nb += pad
    return bytes(out) + acc.to_bytes(nb // 8, "big")
