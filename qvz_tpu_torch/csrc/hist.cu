// K3: conditional symbol histograms, the statistics of the codebook design.
//
// Replaces the TPU kernel qvz_tpu/ops/pallas_kernels.py::_hist_kernel
// (entry cond_hist_fused) and the XLA scan qvz_tpu/ops/stats.py::
// _hist_device that is the TPU default. Both compute, for every adjacent
// column pair (c-1, c) and every read,
//
//   cond[cl, c-1, prev, cur] += 1    prev = x[c-1], cur = x[c], cl its cluster
//
// and this kernel also counts the first column, counts0[cl, x[0]] += 1, in
// the same launch (reference: src/codebook.c:185-220).
//
// What bounds it on an H100 (measured, NVIDIA H100 80GB HBM3, 700 W, 1M
// reads x 100 columns): not the shared-memory atomics' collisions. The
// kernel before this one (one pair and one byte a thread, each column read
// twice, the ids once a pair) took 0.23 ms at C = 1 and 0.37 ms at C = 3
// of device time, held by its loads. This one takes 0.075-0.082 and
// 0.089-0.093 ms, 2.4-2.7 times its bound by bytes (0.031 and 0.034 ms:
// the columns and ids read once, the counts written once); on binned
// qualities (four values, most of a warp's increments on one bin)
// 0.075-0.088 ms, no slower, because the card's shared increment,
// ATOMS.POPC.INC, already takes a warp's equal addresses at once. At
// C = 150 (200,000 x 20, mode 1) 0.078 ms against 0.037. What holds it
// now was not measured: its 100 M increments run at about 4.7 an SM and
// clock, the floor of its counted SASS is 0.031 ms by issue, and no
// profiler of stalls runs on that machine.
//
// What the design does about it:
// - A block takes a band of `band` consecutive column pairs and a slice of
//   the reads. A thread takes 16 reads at a time in 16-byte loads: their
//   cluster ids once, then the band's columns in order, two columns loaded
//   ahead of the one it counts, the previous column kept in registers. So
//   each column is read once a band (the band's first previous column
//   twice), the ids once a band. The first band also counts column 0.
// - The (prev, cur) bins of two reads are computed at once in the 16-bit
//   halves of a word (__byte_perm, one multiply-add).
// - Mode 0: the band's C x 5,184 bins a pair, and column 0's C x 72, are
//   uint32 counters in shared memory; at the end the block adds its
//   non-zero bins into the zeroed int64 output with 64-bit atomics (exact
//   integers, so the order of the sums changes nothing). Mode 1, where one
//   pair's bins do not fit in shared memory (C >= 12): the increments go
//   straight to the int64 output through L2, so no block reads reads it
//   does not count.
// - Mode 1 merges a warp's equal bins first: __match_any_sync groups
//   them, and the lowest lane of each group adds the group's size, since
//   the card does not merge 64-bit device atomics. Mode 0 does not: the
//   card's shared increment, ATOMS.POPC.INC, already takes a warp's equal
//   addresses at once, and the match made it several times slower
//   (PERF.md, K3's row).
// - A cluster id at or past n_clusters counts nothing (one SIMD compare for
//   4 reads), as in the kernel before this one.
// - The launch shape (band, slice, threads, mode) comes from the host's
//   planner, qvz_tpu_torch/ops/stats.py::hist_shape.
//
// Per-block counts are uint32: the planner keeps every slice below 2^31
// reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 72;
constexpr int kBins = kAlphabet * kAlphabet;
constexpr int kGroup = 16;          // reads a thread takes at once
constexpr int kMaxThreads = 1024;
constexpr int64_t kMaxSlice = int64_t{1} << 31;

// Bytes [r, r + 16) of a row of n bytes, zero past n. vec is 16 when every
// row starts on 16 bytes (and r is a multiple of 16), 4 when on 4, else 1.
__device__ __forceinline__ uint4 load16(const uint8_t* row, int64_t r,
                                        int64_t n, int vec) {
  if (r + kGroup <= n) {
    if (vec == 16) return __ldg(reinterpret_cast<const uint4*>(row + r));
    if (vec == 4) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(row + r);
      return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    if (r + k < n)
      w[k >> 2] |= static_cast<uint32_t>(row[r + k]) << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Bytes 0, 1 (s = 0) or 2, 3 (s = 1) of w in the two 16-bit halves.
__device__ __forceinline__ uint32_t halves(uint32_t w, int s) {
  return __byte_perm(w, 0, s ? 0x4342 : 0x4140);
}

// One increment of *dst by a lane whose bin is `key`; invalid lanes count
// nothing. With kMerge the lanes of equal keys add once, by the group's
// lowest lane (every lane of the warp takes part). Mode 1 merges.
template <bool kMerge, typename T>
__device__ __forceinline__ void bump(T* dst, uint32_t key, bool valid,
                                     int lane) {
  uint32_t add = 1;
  if (kMerge) {
    const uint32_t peers =
        __match_any_sync(0xffffffffu, valid ? key : 0xffffffffu);
    valid = valid && __ffs(peers) - 1 == lane;
    add = __popc(peers);
  }
  if (valid) atomicAdd(dst, static_cast<T>(add));
}

template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
    hist_kernel(const uint8_t* __restrict__ data_t,
                const uint8_t* __restrict__ ids, int64_t n, int cols,
                int n_clusters, int band, int64_t slice, int vec,
                unsigned long long* __restrict__ counts0,
                unsigned long long* __restrict__ cond) {
  extern __shared__ uint4 smem4[];
  uint32_t* h = reinterpret_cast<uint32_t*>(smem4);
  const int pairs = cols - 1;
  // the band's first pair is columns (p0 - 1, p0)
  const int p0 = 1 + static_cast<int>(blockIdx.y) * band;
  const int np = max(0, min(band, cols - p0));
  const bool first = blockIdx.y == 0;
  // mode 0's layout: counts0's C x 72, then pair j's C x 5,184
  const int h0 = n_clusters * kAlphabet;
  const int per_pair = n_clusters * kBins;
  const int words4 = (h0 + np * per_pair) / 4;
  if (!kGlobal) {
    for (int w = threadIdx.x; w < words4; w += blockDim.x)
      smem4[w] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * slice;
  const int64_t hi = min(n, lo + slice);
  const int64_t gstride = static_cast<int64_t>(pairs) * kBins;
  const uint8_t* col = data_t + static_cast<int64_t>(p0 - 1) * n;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Rounds are uniform over the block, so every warp is whole at
  // __match_any_sync; reads at or past hi count nothing.
  for (int64_t base = lo; base < hi;
       base += static_cast<int64_t>(kGroup) * blockDim.x) {
    const int64_t r = base + kGroup * threadIdx.x;
    const int64_t left = hi - r;
    const int nv = left <= 0        ? 0
                   : left >= kGroup ? kGroup
                                    : static_cast<int>(left);
    // bit k: read r + k is below hi and of a cluster below n_clusters;
    // an id out of range is zeroed, so mode 0's keys stay in 16 bits
    uint32_t live = (1u << nv) - 1;
    uint4 q = zero;
    if (ids) {
      const uint4 u = load16(ids, r, n, vec);
      uint32_t w[4] = {u.x, u.y, u.z, u.w};
      const uint32_t cc = 0x01010101u * static_cast<uint32_t>(n_clusters);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t bad = __vcmpgeu4(w[i], cc);  // 0xff a byte >= C
        w[i] &= ~bad;
        // the bytes' top bits to bits 28-31
        live &= ~((((bad & 0x80808080u) * 0x00204081u) >> 28) << (4 * i));
      }
      q = make_uint4(w[0], w[1], w[2], w[3]);
    }
    uint4 prev = load16(col, r, n, vec);
    uint4 a = np > 0 ? load16(col + n, r, n, vec) : zero;
    uint4 b = np > 1 ? load16(col + 2 * n, r, n, vec) : zero;

    if (first) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t k2 = halves(word(q, i), s) * kAlphabet
                              + halves(word(prev, i), s);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const uint32_t key = t ? k2 >> 16 : k2 & 0xffff;
            const bool valid = (live >> (4 * i + 2 * s + t)) & 1;
            if (kGlobal)
              bump<true>(counts0 + key, key, valid, lane);
            else
              bump<false>(h + key, key, valid, lane);
          }
        }
    }
    // mode 0: q x 5,184 two a word (at most 11 x 5,184 + 5,183 in a half)
    uint32_t qq[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        qq[2 * i + s] = kGlobal ? 0 : halves(word(q, i), s) * kBins;

    for (int j = 0; j < np; ++j) {
      const uint4 cur = a;
      a = b;
      if (j + 2 < np)
        b = load16(col + static_cast<int64_t>(j + 3) * n, r, n, vec);
      uint32_t* hp = h + h0 + j * per_pair;
      unsigned long long* gp = cond + static_cast<int64_t>(p0 - 1 + j) * kBins;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t k2 = halves(word(prev, i), s) * kAlphabet
                              + halves(word(cur, i), s) + qq[2 * i + s];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const uint32_t pc = t ? k2 >> 16 : k2 & 0xffff;
            const bool valid = (live >> (4 * i + 2 * s + t)) & 1;
            if (kGlobal) {
              const uint32_t qe = (word(q, i) >> (16 * s + 8 * t)) & 0xff;
              bump<true>(gp + qe * gstride + pc, qe * kBins + pc, valid,
                         lane);
            } else {
              bump<false>(hp + pc, pc, valid, lane);
            }
          }
        }
      prev = cur;
    }
  }

  if (!kGlobal) {
    __syncthreads();
    for (int w = threadIdx.x; w < words4; w += blockDim.x) {
      const uint4 v = smem4[w];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t c = word(v, e);
        if (c == 0) continue;
        const int k = 4 * w + e;
        unsigned long long* dst;
        if (k < h0) {
          dst = counts0 + k;
        } else {
          const int j = (k - h0) / per_pair;
          const int rem = k - h0 - j * per_pair;
          const int cl = rem / kBins;
          dst = cond + (static_cast<int64_t>(cl) * pairs + p0 - 1 + j) * kBins
                + (rem - cl * kBins);
        }
        atomicAdd(dst, static_cast<unsigned long long>(c));
      }
    }
  }
}

template <bool kGlobal>
cudaError_t launch(dim3 grid, int threads, int smem, cudaStream_t stream,
                   const uint8_t* data_t, const uint8_t* ids, int64_t n,
                   int cols, int n_clusters, int band, int64_t slice, int vec,
                   int64_t* counts0, int64_t* cond) {
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel<kGlobal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  hist_kernel<kGlobal><<<grid, threads, smem, stream>>>(
      data_t, ids, n, cols, n_clusters, band, slice, vec,
      reinterpret_cast<unsigned long long*>(counts0),
      reinterpret_cast<unsigned long long*>(cond));
  return cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream` in the shape of ops/stats.py::hist_shape; returns
// the first CUDA error of the set-up or the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take. data_t:
// (cols, n) uint8; ids: (n,) uint8 or null (one cluster), an id at or past
// n_clusters not counted; counts0: (C, 72) and cond: (C, cols-1, 72, 72)
// int64, zeroed by the caller. The loads are 16 bytes wide where n and both
// pointers allow, else 4, else 1.
extern "C" int qvz_hist(const uint8_t* data_t, const uint8_t* ids, int64_t n,
                        int cols, int n_clusters, int mode, int band,
                        int64_t slice, int nslices, int threads, int smem,
                        int64_t* counts0, int64_t* cond, void* stream) {
  if (n <= 0 || cols <= 0 || n_clusters <= 0) return 0;
  const int pairs = cols - 1;
  const int nbands = pairs > 0 && band > 0 ? (pairs + band - 1) / band : 1;
  const int live = pairs < band ? pairs : band;
  const int64_t want_smem =
      mode == 0 ? 4 * (static_cast<int64_t>(n_clusters) * kAlphabet
                       + static_cast<int64_t>(live) * n_clusters * kBins)
                : 0;
  // mode 0 keeps a bin's key in 16 bits: at most 11 x 5,184 + 5,183
  if (n_clusters > 255 || (mode != 0 && mode != 1) || band < 1
      || (mode == 0 && n_clusters > 12)
      || slice <= 0 || slice % kGroup != 0 || slice >= kMaxSlice
      || nslices < 1 || (nslices - 1) * slice >= n || nslices * slice < n
      || threads < 32 || threads > kMaxThreads || threads % 32 != 0
      || smem != want_smem
      || nbands > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(data_t)
                          | reinterpret_cast<uintptr_t>(ids)
                          | static_cast<uintptr_t>(n);
  const int vec = align % 16 == 0 ? 16 : align % 4 == 0 ? 4 : 1;
  const dim3 grid(static_cast<unsigned>(nslices),
                  static_cast<unsigned>(nbands));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      mode == 0 ? launch<false>(grid, threads, smem, s, data_t, ids, n, cols,
                                n_clusters, band, slice, vec, counts0, cond)
                : launch<true>(grid, threads, smem, s, data_t, ids, n, cols,
                               n_clusters, band, slice, vec, counts0, cond);
  return static_cast<int>(e);
}
