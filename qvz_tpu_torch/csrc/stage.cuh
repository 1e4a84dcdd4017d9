// Asynchronous staging of device-memory rows into shared memory (cp.async),
// shared by K1 (quantize.cu) and K4 (kmeans.cu).
//
// A row is `n` bytes long (a (rows, n) uint8 array); the copies read its
// bytes [r0, r0 + len) and zero-fill what lies past n. `vec` is the width
// of one copy, the largest of 16 and 4 that divides n (so every row starts
// at a multiple of it, the array's base being 16-byte aligned), or 1: then
// the bytes are copied by plain loads and stores, synchronously.

#pragma once

#include <cstdint>

namespace qvz_stage {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first `bytes` (0 or 16) are read and the rest
// zero-filled; bypasses L1.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `kPending` of this thread's committed groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows [0, rows) of src (row stride n) to dst (row stride dst_stride),
// bytes [r0, r0 + len) of each; len a multiple of 16. The block's threads
// share the copies: thread `tid` of `nthreads`.
__device__ __forceinline__ void rows(uint8_t* dst, int dst_stride,
                                     const uint8_t* src, int64_t n, int nrows,
                                     int64_t r0, int len, int vec, int tid,
                                     int nthreads) {
  if (vec == 16) {
    const int per = len / 16;
#pragma unroll 1
    for (int q = tid; q < nrows * per; q += nthreads) {
      const int c = q / per;
      const int o = (q - c * per) * 16;
      const int64_t r = r0 + o;
      const bool in = r < n;
      copy16(dst + static_cast<int64_t>(c) * dst_stride + o,
             in ? src + static_cast<int64_t>(c) * n + r : src, in ? 16 : 0);
    }
  } else if (vec == 4) {
    const int per = len / 4;
#pragma unroll 1
    for (int q = tid; q < nrows * per; q += nthreads) {
      const int c = q / per;
      const int o = (q - c * per) * 4;
      const int64_t r = r0 + o;
      const bool in = r < n;
      copy4(dst + static_cast<int64_t>(c) * dst_stride + o,
            in ? src + static_cast<int64_t>(c) * n + r : src, in ? 4 : 0);
    }
  } else {
#pragma unroll 1
    for (int q = tid; q < nrows * len; q += nthreads) {
      const int c = q / len;
      const int o = q - c * len;
      const int64_t r = r0 + o;
      dst[static_cast<int64_t>(c) * dst_stride + o] =
          r < n ? src[static_cast<int64_t>(c) * n + r] : 0;
    }
  }
}

}  // namespace qvz_stage
