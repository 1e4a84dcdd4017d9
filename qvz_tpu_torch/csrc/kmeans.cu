// K4: one Lloyd step of the read clustering, in one pass over the reads.
//
// Replaces the TPU kernel qvz_tpu/ops/pallas_kernels.py::_kmeans_kernel
// (entry kmeans_step_fused, the TPU default for -c > 1). Semantics of
// src/cluster.c:80-171: exact integer squared-L2 distance of every read
// to every mean, the first minimum wins (strict < over k ascending, so a
// tie goes to the lowest index, cluster.c:159), then per-cluster integer
// sums of the reads' symbols and the cluster sizes.
//
// What bounds it on an H100: device-memory bytes at small K (the (cols, N)
// uint8 reads, read once: 100 MB at 1M x 100), the integer arithmetic of
// the distances at large K.
//
// What the design does about it:
// - One pass over device memory. A block walks tiles of T reads (T chosen
//   from cols by ops/kmeans.py::step_shape so that two tiles fit), each
//   tile cols rows of T bytes copied into shared memory with 16-byte
//   cp.async, double-buffered: the next tile lands while this one is
//   computed. The distances and the sums both read the tile there.
// - Distances four columns at a time. A thread takes 4 adjacent reads:
//   four 4-byte loads (4 columns x 4 reads) and a byte transpose give each
//   read's 4 columns in one word; then per mean one __vabsdiffu4 and one
//   __dp4a add 4 squared differences. The means are packed the same way,
//   (cols4/4, k_pad) words, in shared memory and broadcast to the warp;
//   KT running distances a read stay in registers, and the columns are
//   walked once per KT means. Full squared L2, at most 1022 * 255^2 < 2^31:
//   exact, and the first minimum is the reference's. The TPU kernel's
//   ||m||^2 - 2x.m form has the same argmin; it would save work only at a
//   K far above the plans' (phase 16 runs K = 150 at 20 columns).
// - Sums without warp reductions. With K <= 8 (MODE 0) the tile's
//   assignments become one 0/1 byte mask a cluster and a 4-read group; a
//   thread owns one column and adds 16 of its bytes at a time into KT
//   register accumulators with __dp4a against the masks. Above that
//   (MODE 1) a thread adds each byte into per-block accumulators in shared
//   memory; where those do not fit (MODE 2) straight into the global
//   sums. The counts are a last column of the same (K, cols + 1) output.
//   Each block adds its accumulators into the int64 output once, at the end.
//
// Per-block accumulators are uint32: a block owns at most 2^23 reads
// (step_shape's grid), and 2^23 * 255 < 2^32.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReads = 4;     // reads a thread in the distance pass
constexpr int kRowPad = 16;   // a tile row's stride is T + kRowPad bytes
constexpr unsigned char kNone = 0xff;  // s_assign of a read past n

__host__ __device__ inline int64_t up16(int64_t b) {
  return (b + 15) / 16 * 16;
}

// Shared-memory layout: [two tiles (cols4, T + kRowPad) u8] [means
// (cols4/4, k_pad) u32, if shared] [MODE 0: masks (KT, T/4) u32; else
// assignments (T,) u8] [MODE 1: sums and counts (k, cols + 1) u32].
struct Layout {
  int64_t stride, tile, means, marks, sums, bytes;
  __host__ __device__ Layout(int T, int cols, int k, int k_pad, int kt,
                             int mode, bool means_shared) {
    const int cols4 = (cols + 3) / 4 * 4;
    stride = T + kRowPad;
    tile = cols4 * stride;
    means = 2 * tile;
    marks = means + up16(means_shared ? int64_t{cols4} * k_pad : 0);
    sums = marks + up16(mode == 0 ? int64_t{kt} * T : T);
    bytes = sums + (mode == 1 ? int64_t{k} * (cols + 1) * 4 : 0);
  }
};

// The tile of reads [r0, r0 + T) of every row into `dst` (row stride
// `stride`): 16-byte copies where n % 16 == 0 (vec 16), else
// qvz_stage::rows. T is a power of two, so a thread keeps one 16-byte
// column offset of the tile and walks the rows kThreads / (T / 16) apart.
__device__ __forceinline__ void stage_tile(uint8_t* dst, int stride,
                                           const uint8_t* src, int64_t n,
                                           int cols, int64_t r0, int T,
                                           int vec, int tid) {
  if (vec != 16) {
    qvz_stage::rows(dst, stride, src, n, cols, r0, T, vec, tid, kThreads);
    return;
  }
  const int per = T / 16;
  const int j = tid & (per - 1);
  const int64_t r = r0 + 16 * j;
  const int bytes = r < n ? 16 : 0;
  const uint8_t* s = src + (bytes ? r : 0);
  uint8_t* d = dst + 16 * j;
#pragma unroll 1
  for (int c = tid / per; c < cols; c += kThreads / per)
    qvz_stage::copy16(d + c * stride, s + static_cast<int64_t>(c) * n, bytes);
}

template <int KT, int MODE>
__global__ void __launch_bounds__(kThreads)
    kmeans_kernel(const uint8_t* __restrict__ data_t, int64_t n, int cols,
                  const uint32_t* __restrict__ means4, int k, int k_pad,
                  bool means_shared, int T, int vec,
                  int32_t* __restrict__ assign,
                  unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(T, cols, k, k_pad, KT, MODE, means_shared);
  const int tid = threadIdx.x;
  const int cols4 = (cols + 3) / 4 * 4;
  const int groups = cols4 / 4;
  const int stride = static_cast<int>(lay.stride);
  uint32_t* s_means = reinterpret_cast<uint32_t*>(smem + lay.means);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + lay.marks);
  uint8_t* s_assign = smem + lay.marks;
  uint32_t* s_sums = reinterpret_cast<uint32_t*>(smem + lay.sums);
  const int64_t ntiles = (n + T - 1) / T;
  int64_t tile = blockIdx.x;

  // The first tile's copies go out before the set-up below.
  if (tile < ntiles)
    stage_tile(smem, stride, data_t, n, cols, tile * T, T, vec, tid);
  qvz_stage::commit();
  // Rows cols..cols4-1 of both tiles stay zero (as do the means' padding
  // columns): they add nothing to a distance.
  for (int q = tid; q < 2 * (cols4 - cols) * stride; q += kThreads) {
    const int b = q / ((cols4 - cols) * stride);
    const int r = q - b * (cols4 - cols) * stride;
    smem[b * lay.tile + int64_t{cols} * stride + r] = 0;
  }
  if (means_shared) {
    for (int q = tid; q < groups * k_pad; q += kThreads)
      s_means[q] = means4[q];
  }
  if (MODE == 1) {
    for (int q = tid; q < k * (cols + 1); q += kThreads) s_sums[q] = 0;
  }
  const uint32_t* mt = means_shared ? s_means : means4;

  uint32_t acc[KT];   // MODE 0: this thread's column's sums by cluster
  uint32_t cnt[KT];   // MODE 0: this thread's reads by cluster
#pragma unroll
  for (int j = 0; j < KT; ++j) acc[j] = cnt[j] = 0;
  // MODE 0: thread tid sums column tid % cols over the tile's 16-read
  // chunks phase, phase + phases, ...
  const int phases = MODE == 0 ? kThreads / cols : 1;
  const int my_col = MODE == 0 ? tid % cols : 0;
  const int phase = MODE == 0 ? tid / cols : 0;

  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const uint8_t* cur = smem + (it & 1) * lay.tile;
    const int64_t next = tile + gridDim.x;
    if (next < ntiles)
      stage_tile(smem + ((it + 1) & 1) * lay.tile, stride, data_t, n, cols,
                 next * T, T, vec, tid);
    qvz_stage::commit();
    qvz_stage::wait<1>();
    __syncthreads();

    // -- distances and assignments: reads 4 tid .. 4 tid + 3 of the tile --
    const int64_t t0 = tile * T;
    if (tid < T / kReads) {
      const int64_t i0 = t0 + kReads * tid;
      uint32_t best_d[kReads];
      int best[kReads];
#pragma unroll
      for (int r = 0; r < kReads; ++r) {
        best_d[r] = UINT_MAX;
        best[r] = 0;
      }
#pragma unroll 1
      for (int k0 = 0; k0 < k; k0 += KT) {
        uint32_t d[kReads][KT];
#pragma unroll
        for (int r = 0; r < kReads; ++r) {
#pragma unroll
          for (int j = 0; j < KT; ++j) d[r][j] = 0;
        }
        const uint8_t* row = cur + kReads * tid;
        const uint32_t* m = mt + k0;
#pragma unroll 1
        for (int g = 0; g < groups; ++g) {
          // a_j: column 4g + j of the 4 reads; x_r: read r's 4 columns
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(row);
          const uint32_t a1 =
              *reinterpret_cast<const uint32_t*>(row + stride);
          const uint32_t a2 =
              *reinterpret_cast<const uint32_t*>(row + 2 * stride);
          const uint32_t a3 =
              *reinterpret_cast<const uint32_t*>(row + 3 * stride);
          const uint32_t lo01 = __byte_perm(a0, a1, 0x5140);
          const uint32_t hi01 = __byte_perm(a0, a1, 0x7362);
          const uint32_t lo23 = __byte_perm(a2, a3, 0x5140);
          const uint32_t hi23 = __byte_perm(a2, a3, 0x7362);
          const uint32_t x[kReads] = {__byte_perm(lo01, lo23, 0x5410),
                                      __byte_perm(lo01, lo23, 0x7632),
                                      __byte_perm(hi01, hi23, 0x5410),
                                      __byte_perm(hi01, hi23, 0x7632)};
          uint32_t mm[KT];
#pragma unroll
          for (int j = 0; j < KT; j += 4) {
            const uint4 v = *reinterpret_cast<const uint4*>(m + j);
            mm[j] = v.x;
            mm[j + 1] = v.y;
            mm[j + 2] = v.z;
            mm[j + 3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < KT; ++j) {
#pragma unroll
            for (int r = 0; r < kReads; ++r) {
              const uint32_t e = __vabsdiffu4(x[r], mm[j]);
              d[r][j] = __dp4a(e, e, d[r][j]);
            }
          }
          row += 4 * stride;
          m += k_pad;
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) {
#pragma unroll
          for (int r = 0; r < kReads; ++r) {
            if (k0 + j < k && d[r][j] < best_d[r]) {
              best_d[r] = d[r][j];
              best[r] = k0 + j;
            }
          }
        }
      }
      bool valid[kReads];
#pragma unroll
      for (int r = 0; r < kReads; ++r) valid[r] = i0 + r < n;
      if (valid[kReads - 1]) {
        *reinterpret_cast<int4*>(assign + i0) =
            make_int4(best[0], best[1], best[2], best[3]);
      } else {
#pragma unroll
        for (int r = 0; r < kReads; ++r)
          if (valid[r]) assign[i0 + r] = best[r];
      }
      if (MODE == 0) {
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          uint32_t mask = 0;
#pragma unroll
          for (int r = 0; r < kReads; ++r) {
            const bool hit = valid[r] && best[r] == j;
            mask |= static_cast<uint32_t>(hit) << (8 * r);
            cnt[j] += hit;
          }
          s_mask[j * (T / kReads) + tid] = mask;
        }
      } else {
        uint32_t packed = 0;
#pragma unroll
        for (int r = 0; r < kReads; ++r) {
          packed |= static_cast<uint32_t>(valid[r] ? best[r] : kNone)
                    << (8 * r);
          if (valid[r]) {
            const int64_t o = int64_t{best[r]} * (cols + 1) + cols;
            if (MODE == 1) {
              atomicAdd(&s_sums[o], 1u);
            } else {
              atomicAdd(&out[o], 1ull);
            }
          }
        }
        *reinterpret_cast<uint32_t*>(s_assign + kReads * tid) = packed;
      }
    }
    __syncthreads();

    // -- sums: the tile's column rows, 16 reads at a time --
    const int chunks = T / 16;
    if (MODE == 0) {
      if (phase < phases) {
        const uint8_t* row = cur + int64_t{my_col} * stride;
#pragma unroll 1
        for (int q = phase; q < chunks; q += phases) {
          const uint4 x = *reinterpret_cast<const uint4*>(row + 16 * q);
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            const uint4 w = *reinterpret_cast<const uint4*>(
                s_mask + j * (T / kReads) + 4 * q);
            acc[j] = __dp4a(x.x, w.x, acc[j]);
            acc[j] = __dp4a(x.y, w.y, acc[j]);
            acc[j] = __dp4a(x.z, w.z, acc[j]);
            acc[j] = __dp4a(x.w, w.w, acc[j]);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int item = tid; item < cols * chunks; item += kThreads) {
        const int q = item / cols;
        const int c = item - q * cols;
        const uint4 x = *reinterpret_cast<const uint4*>(
            cur + int64_t{c} * stride + 16 * q);
        const uint4 a = *reinterpret_cast<const uint4*>(s_assign + 16 * q);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t as[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t cl = (as[w] >> (8 * b)) & 0xffu;
            const uint32_t v = (xs[w] >> (8 * b)) & 0xffu;
            if (cl != kNone && v != 0) {
              const int64_t o = int64_t{cl} * (cols + 1) + c;
              if (MODE == 1) {
                atomicAdd(&s_sums[o], v);
              } else {
                atomicAdd(&out[o], static_cast<unsigned long long>(v));
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the tile's buffer and marks are rewritten next
  }

  // -- the block's accumulators into the int64 output, once --
  if (MODE == 0) {
    if (phase < phases) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (j < k && acc[j])
          atomicAdd(&out[int64_t{j} * (cols + 1) + my_col],
                    static_cast<unsigned long long>(acc[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const uint32_t s = __reduce_add_sync(0xffffffffu, cnt[j]);
      if ((tid & 31) == 0 && j < k && s)
        atomicAdd(&out[int64_t{j} * (cols + 1) + cols],
                  static_cast<unsigned long long>(s));
    }
  } else if (MODE == 1) {
    for (int q = tid; q < k * (cols + 1); q += kThreads) {
      if (s_sums[q])
        atomicAdd(&out[q], static_cast<unsigned long long>(s_sums[q]));
    }
  }
}

template <int KT, int MODE>
cudaError_t launch(int grid, int64_t smem, cudaStream_t stream,
                   const uint8_t* data_t, int64_t n, int cols,
                   const uint32_t* means4, int k, int k_pad,
                   bool means_shared, int T, int vec, int32_t* assign,
                   int64_t* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kmeans_kernel<KT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kmeans_kernel<KT, MODE><<<grid, kThreads, smem, stream>>>(
      data_t, n, cols, means4, k, k_pad, means_shared, T, vec, assign,
      reinterpret_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

}  // namespace

// Launches K4 on `stream`; returns the first CUDA error of the set-up or
// the launch. data_t: (cols, n) uint8; means4: (cols4/4, k_pad) uint32,
// word (g, j) holding columns 4g..4g+3 of mean j, one byte each (padding
// zero; ops/kmeans.py::pack_means); assign: (n,) int32; out: (k, cols + 1)
// int64, the sums and in the last column the counts, zeroed by the caller.
// The shape (kt, mode, means_shared, T, smem, grid) is
// ops/kmeans.py::step_shape's; smem must equal this file's Layout.
extern "C" int qvz_kmeans_step(const uint8_t* data_t, int64_t n, int cols,
                               const uint32_t* means4, int k, int k_pad,
                               int kt, int mode, int means_shared, int T,
                               int64_t smem, int grid, int32_t* assign,
                               int64_t* out, void* stream) {
  if (n <= 0 || cols <= 0 || k <= 0) return 0;
  const bool ms = means_shared != 0;
  if ((kt != 4 && kt != 8) || k_pad % kt != 0 || k_pad < k || k > 255
      || T < 16 || T > kThreads * kReads || (T & (T - 1)) != 0 || grid <= 0
      || (mode == 0 && (k > kt || cols > kThreads)) || mode < 0 || mode > 2
      || Layout(T, cols, k, k_pad, kt, mode, ms).bytes != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n % 16 == 0 ? 16 : n % 4 == 0 ? 4 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define QVZ_K4(KT_, MODE_)                                                   \
  e = launch<KT_, MODE_>(grid, smem, s, data_t, n, cols, means4, k, k_pad,  \
                         ms, T, vec, assign, out)
  if (kt == 4) {
    if (mode == 0) QVZ_K4(4, 0);
    else if (mode == 1) QVZ_K4(4, 1);
    else QVZ_K4(4, 2);
  } else {
    if (mode == 0) QVZ_K4(8, 0);
    else if (mode == 1) QVZ_K4(8, 1);
    else QVZ_K4(8, 2);
  }
#undef QVZ_K4
  return static_cast<int>(e);
}
