"""Replication of glibc's rand() (TYPE_3 additive-feedback generator);
a copy of ``qvz_tpu.utils.glibc_rand``.

The reference seeds k-means centroids from unseeded libc rand() calls
(src/cluster.c:192-206), which on glibc is fully deterministic (seed 1).
Cluster ids end up inside the arithmetic-coded payload, so multi-cluster
bitstream parity requires reproducing this exact stream.

glibc TYPE_3: 34-word state; r[0]=seed; r[i]=16807*r[i-1] mod 2^31-1 via
Schrage for i in 1..30; r[31..33]=r[0..2]; the generator discards its first
310 outputs; output = ((r[i-3]+r[i-31]) mod 2^32) >> 1.
"""


class GlibcRand:
    """Stateful replica of glibc rand()/srand()."""

    def __init__(self, seed: int = 1):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed &= 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = seed
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        # Ring buffer of the last 31 values plus front pointer; glibc
        # discards the first 310 outputs during initialization.
        self._hist = r
        self._idx = 34
        for _ in range(310):
            self._next()

    def _next(self) -> int:
        h = self._hist
        v = (h[self._idx - 3] + h[self._idx - 31]) & 0xFFFFFFFF
        h.append(v)
        self._idx += 1
        # Keep the history bounded.
        if len(h) > 4096:
            del h[: self._idx - 31]
            self._idx = 31
        return v

    def rand(self) -> int:
        return self._next() >> 1
