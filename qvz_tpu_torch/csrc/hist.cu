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
// What bounds it on an H100: shared-memory atomics, not bandwidth. Each
// read and pair is one 2-byte load and one atomic increment; quality
// scores crowd a few dozen (prev, cur) bins, so the atomics of a warp
// collide and serialise.
//
// What the design does about it: a block owns one column pair (blockIdx.x;
// x = 0 is the first column's histogram) and one slice of the reads
// (blockIdx.y), and keeps that pair's C*72*72 histogram in dynamic shared
// memory (20,736 B a cluster), so the atomics never reach device memory.
// The inputs are (cols, N) column-major, so the warp's loads of a column
// are coalesced. At the end the block adds its non-zero bins into the
// global int64 result with 64-bit atomics: exact integers, so the order of
// the sums changes nothing. Clusters past what shared memory holds
// (11 a block, 228 KB) are split over blockIdx.z; a block skips the reads
// of other clusters, so any C up to 255 is counted.
//
// Per-block counts are uint32: the host cuts the reads into slices of at
// most 2^31.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphabet = 72;
constexpr int kBins = kAlphabet * kAlphabet;
constexpr int kThreads = 512;
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kTargetBlocks = 132 * 8;

__global__ void hist_kernel(const uint8_t* __restrict__ data_t,
                            const uint8_t* __restrict__ clusters, int64_t n,
                            int cols, int n_clusters, int cl_per_block,
                            int64_t slice,
                            unsigned long long* __restrict__ counts0,
                            unsigned long long* __restrict__ cond) {
  extern __shared__ uint32_t h[];
  const int pair = blockIdx.x;  // 0: column 0; p >= 1: columns (p-1, p)
  const int cl0 = blockIdx.z * cl_per_block;
  const int ncl = min(cl_per_block, n_clusters - cl0);
  const int per_cl = pair == 0 ? kAlphabet : kBins;
  const int nbins = ncl * per_cl;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) h[k] = 0;
  __syncthreads();

  const int64_t lo = static_cast<int64_t>(blockIdx.y) * slice;
  const int64_t hi = min(n, lo + slice);
  const uint8_t* cur = data_t + static_cast<int64_t>(pair) * n;
  const uint8_t* prev = pair == 0 ? nullptr : cur - n;
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int cl = (clusters ? static_cast<int>(clusters[i]) : 0) - cl0;
    if (cl < 0 || cl >= ncl) continue;
    const int b = prev ? static_cast<int>(prev[i]) * kAlphabet + cur[i]
                       : static_cast<int>(cur[i]);
    atomicAdd(&h[cl * per_cl + b], 1u);
  }
  __syncthreads();

  // counts0 is (C, 72); cond is (C, cols-1, 72, 72).
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) {
    const uint32_t v = h[k];
    if (v == 0) continue;
    const int cl = cl0 + k / per_cl;
    const int b = k % per_cl;
    unsigned long long* dst =
        pair == 0
            ? counts0 + static_cast<int64_t>(cl) * kAlphabet + b
            : cond + (static_cast<int64_t>(cl) * (cols - 1) + (pair - 1))
                         * kBins + b;
    atomicAdd(dst, static_cast<unsigned long long>(v));
  }
}

}  // namespace

// Launches K3 on `stream`; returns the first CUDA error of the set-up or
// the launch. data_t: (cols, n) uint8; clusters: (n,) uint8 or null (one
// cluster); counts0: (C, 72) and cond: (C, cols-1, 72, 72) int64, zeroed
// by the caller.
extern "C" int qvz_hist(const uint8_t* data_t, const uint8_t* clusters,
                        int64_t n, int cols, int n_clusters, int64_t* counts0,
                        int64_t* cond, void* stream) {
  if (n <= 0 || cols <= 0 || n_clusters <= 0) return 0;
  const int cl_per_block =
      std::min(n_clusters, kMaxSharedBytes / (kBins * 4));
  const int zs = (n_clusters + cl_per_block - 1) / cl_per_block;
  const int smem = cl_per_block * kBins * 4;
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Enough slices of the reads to fill the card, each below 2^32 reads.
  int64_t ys = (kTargetBlocks + static_cast<int64_t>(cols) * zs - 1)
               / (static_cast<int64_t>(cols) * zs);
  ys = std::min<int64_t>(ys, (n + kThreads - 1) / kThreads);
  ys = std::max<int64_t>(ys, 1);
  ys = std::max<int64_t>(ys, (n >> 31) + 1);
  const int64_t slice = (n + ys - 1) / ys;
  const dim3 grid(cols, static_cast<unsigned>((n + slice - 1) / slice), zs);
  hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      data_t, clusters, n, cols, n_clusters, cl_per_block, slice,
      reinterpret_cast<unsigned long long*>(counts0),
      reinterpret_cast<unsigned long long*>(cond));
  return static_cast<int>(cudaGetLastError());
}
