// K4: one Lloyd step of the read clustering, one thread per read.
//
// Replaces the TPU kernel qvz_tpu/ops/pallas_kernels.py::_kmeans_kernel
// (entry kmeans_step_fused, the TPU default for -c > 1). Semantics of
// src/cluster.c:80-171: exact integer squared-L2 distance of every read
// to every mean, the first minimum wins (strict < over k ascending, so a
// tie goes to the lowest index, cluster.c:159), then per-cluster integer
// sums of the reads' symbols and the cluster sizes.
//
// What bounds it on an H100: at small K, the two coalesced passes over
// the (cols, N) uint8 reads (one for the distances, one for the sums), so
// device-memory bytes; at large K, the integer arithmetic of the
// distances.
//
// What the design does about it: the means sit in shared memory as
// uint8, transposed to (cols, k_pad), so a thread fetches the 8 means of
// one column in one 8-byte load that every lane of the warp shares (a
// broadcast, no bank conflict); a thread keeps 8 running distances in
// registers and walks the columns once per 8 clusters. Distances are full
// squared L2 in int32: at most 1022 * 255^2 < 2^31, exact. The JAX kernel's
// ||m||^2 - 2x.m form has the same argmin; the explicit form needs no
// matrix unit and no f32 exactness argument. For the sums, each warp
// finds the distinct clusters of its 32 reads with ballots, and per column
// and cluster one __reduce_add_sync gives the warp's sum, which lane 0
// adds into per-block uint32 accumulators in shared memory; the block then
// adds its non-zero accumulators into the global int64 sums with 64-bit
// atomics. Exact integers, so the order of the sums changes nothing.
// Where the means (k_pad * cols bytes) or the accumulators
// (4 * K * (cols + 1) bytes) do not fit in shared memory, the kernel reads
// the means from device memory and adds straight into the global sums.
//
// Per-block accumulators are uint32: a block owns at most 2^23 reads, and
// 2^23 * 255 < 2^32.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;  // clusters whose distances a thread holds at once
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kTargetBlocks = 132 * 8;
constexpr int64_t kMaxReadsPerBlock = int64_t{1} << 23;

__host__ __device__ inline int64_t up16(int64_t b) {
  return (b + 15) / 16 * 16;
}

// Shared-memory layout: [means u8 (cols, k_pad)] [warp cluster lists]
// [sums u32 (k, cols)] [counts u32 (k,)], each part 16-byte aligned.
struct Layout {
  int64_t means, groups, sums, counts, bytes;
  __host__ __device__ Layout(int k, int k_pad, int cols, bool means_shared,
                             bool sums_shared) {
    means = 0;
    groups = up16(means_shared ? static_cast<int64_t>(k_pad) * cols : 0);
    sums = groups + up16(kWarps * 32 * 4);
    counts = sums
             + up16(sums_shared ? static_cast<int64_t>(k) * cols * 4 : 0);
    bytes = counts + (sums_shared ? k * 4 : 0);
  }
};

__global__ void kmeans_kernel(const uint8_t* __restrict__ data_t, int64_t n,
                              int cols, const uint8_t* __restrict__ means_t,
                              int k, int k_pad, bool means_shared,
                              bool sums_shared, int32_t* __restrict__ assign,
                              unsigned long long* __restrict__ sums,
                              unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(k, k_pad, cols, means_shared, sums_shared);
  uint8_t* s_means = smem + lay.means;
  int* s_groups = reinterpret_cast<int*>(smem + lay.groups);
  uint32_t* s_sums = reinterpret_cast<uint32_t*>(smem + lay.sums);
  uint32_t* s_counts = reinterpret_cast<uint32_t*>(smem + lay.counts);
  if (means_shared) {
    const int64_t nb = static_cast<int64_t>(k_pad) * cols;
    for (int64_t b = threadIdx.x; b < nb; b += blockDim.x)
      s_means[b] = means_t[b];
  }
  if (sums_shared) {
    for (int64_t b = threadIdx.x; b < static_cast<int64_t>(k) * cols;
         b += blockDim.x)
      s_sums[b] = 0;
    for (int b = threadIdx.x; b < k; b += blockDim.x) s_counts[b] = 0;
  }
  __syncthreads();
  const uint8_t* mt = means_shared ? s_means : means_t;

  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int* groups = s_groups + (threadIdx.x >> 5) * 32;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t i = base + threadIdx.x;
    const bool valid = i < n;

    // Assignment: first minimum of the exact squared distances.
    int best = 0;
    if (valid) {
      int best_d = INT_MAX;
      for (int k0 = 0; k0 < k; k0 += kTile) {
        int d[kTile];
#pragma unroll
        for (int j = 0; j < kTile; ++j) d[j] = 0;
        for (int c = 0; c < cols; ++c) {
          const int x = data_t[static_cast<int64_t>(c) * n + i];
          const uint2 m = *reinterpret_cast<const uint2*>(
              mt + static_cast<int64_t>(c) * k_pad + k0);
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            const unsigned w = j < 4 ? m.x : m.y;
            const int mj = static_cast<int>((w >> (8 * (j & 3))) & 0xffu);
            const int diff = x - mj;
            d[j] += diff * diff;
          }
        }
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          if (k0 + j < k && d[j] < best_d) {
            best_d = d[j];
            best = k0 + j;
          }
        }
      }
      assign[i] = best;
    }

    // The warp's distinct clusters, lowest lane first (warp-uniform).
    unsigned pending = __ballot_sync(full, valid);
    int ng = 0;
    while (pending) {
      const int kk = __shfl_sync(full, best, __ffs(pending) - 1);
      const unsigned members = __ballot_sync(full, valid && best == kk);
      pending &= ~members;
      if (lane == 0) {
        groups[ng] = kk;
        if (sums_shared) {
          atomicAdd(&s_counts[kk], static_cast<uint32_t>(__popc(members)));
        } else {
          atomicAdd(&counts[kk],
                    static_cast<unsigned long long>(__popc(members)));
        }
      }
      ++ng;
    }
    __syncwarp();

    // Sums: one warp reduction per column and present cluster.
    for (int c = 0; c < cols; ++c) {
      const unsigned x =
          valid ? data_t[static_cast<int64_t>(c) * n + i] : 0u;
      for (int g = 0; g < ng; ++g) {
        const int kk = groups[g];
        const unsigned s =
            __reduce_add_sync(full, (valid && best == kk) ? x : 0u);
        if (lane == 0 && s != 0) {
          const int64_t o = static_cast<int64_t>(kk) * cols + c;
          if (sums_shared) {
            atomicAdd(&s_sums[o], s);
          } else {
            atomicAdd(&sums[o], static_cast<unsigned long long>(s));
          }
        }
      }
    }
    __syncwarp();  // the list is rewritten by the next round
  }

  if (sums_shared) {
    __syncthreads();
    for (int64_t b = threadIdx.x; b < static_cast<int64_t>(k) * cols;
         b += blockDim.x) {
      if (s_sums[b]) atomicAdd(&sums[b], static_cast<unsigned long long>(
                                             s_sums[b]));
    }
    for (int b = threadIdx.x; b < k; b += blockDim.x) {
      if (s_counts[b]) atomicAdd(&counts[b], static_cast<unsigned long long>(
                                                 s_counts[b]));
    }
  }
}

}  // namespace

// Launches K4 on `stream`; returns the first CUDA error of the set-up or
// the launch. data_t: (cols, n) uint8; means_t: (cols, k_pad) uint8, the
// means transposed, k_pad a multiple of 8 (pad columns unused);
// assign: (n,) int32; sums: (k, cols) and counts: (k,) int64, zeroed by the
// caller.
extern "C" int qvz_kmeans_step(const uint8_t* data_t, int64_t n, int cols,
                               const uint8_t* means_t, int k, int k_pad,
                               int32_t* assign, int64_t* sums,
                               int64_t* counts, void* stream) {
  if (n <= 0 || cols <= 0 || k <= 0) return 0;
  if (k_pad % kTile != 0 || k_pad < k) return static_cast<int>(
      cudaErrorInvalidValue);
  bool means_shared = true, sums_shared = true;
  if (Layout(k, k_pad, cols, true, true).bytes > kMaxSharedBytes) {
    sums_shared = false;
    if (Layout(k, k_pad, cols, true, false).bytes > kMaxSharedBytes)
      means_shared = false;
  }
  const int smem = static_cast<int>(
      Layout(k, k_pad, cols, means_shared, sums_shared).bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kmeans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = std::min<int64_t>((n + kThreads - 1) / kThreads,
                                     kTargetBlocks);
  blocks = std::max<int64_t>(
      blocks, (n + kMaxReadsPerBlock - 1) / kMaxReadsPerBlock);
  kmeans_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      data_t, n, cols, means_t, k, k_pad, means_shared, sums_shared, assign,
      reinterpret_cast<unsigned long long*>(sums),
      reinterpret_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
