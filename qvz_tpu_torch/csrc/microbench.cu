// Integer-issue microbenchmark kernels: what the card sustains for the
// lane coder's int32 op mix.
//
// Replaces the three TPU kernels of scripts/vpu_microbench.py:
//   issue   <- issue_kernel (pallas_call at :110): 8 loop-carried int32
//              chains a tile element, addxor a + (x ^ r) or cmpsel
//              a > x ? a - x : a + r, summed over the chains.
//   mix     <- mix_kernel (:198): the coder's per-chunk op mix, d = kw - m,
//              below = u32(d) < qs, eq = d == qs, b0 += c * below,
//              b1 += c * eq, c += eq, the counts c carried across reps.
//   selmix  <- selmix_kernel (:331): the mix with selects for the products
//              (sel), 4 steps sharing one load of c and kw (sel_b4), or a
//              load-and-add sweep of c (sweeponly).
//
// What bounds them on an H100: integer issue. The mix legs keep their
// whole working set in shared memory, so device memory is touched once;
// each element a rep is two shared loads, one shared store and 7-9
// integer instructions.
//
// What the design does about it. issue: one thread a tile element holds
// the 8 chains in registers (ILP 8); `reps` is a runtime argument, so the
// loop cannot be folded; `tiles` copies of the (8, 8, 128) tile fill the
// card. mix/selmix: a block takes a contiguous range of rows of the
// leading axis and keeps its slice of c and kw in shared memory for all
// reps (c is loop-carried per element, so blocks need no grid sync);
// threads map to the positions of the trailing axes (consecutive threads,
// consecutive words: no bank conflict); b0 and b1 stay in registers and
// each thread adds b0 + b1 into the output once with a uint32 atomicAdd
// (a sum mod 2^32 does not depend on the order). The mode is a template
// parameter, and each leg is its own kernel, so the SASS of each can be
// read apart (chip_smoke.py prints its inner loop's opcodes). All
// arithmetic is uint32: the TPU kernels wrap mod 2^32, and signed overflow
// would be undefined here. The mix leg multiplies through PTX mad.lo.u32,
// as the TPU kernel multiplies by the 0/1 mask; sweeponly reads c through
// a volatile pointer so that the sweep, whose c never changes, cannot be
// hoisted out of the rep loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8 * 128;     // elements of one (8, 128) tile
constexpr int kChains = 8;
constexpr int kIssueThreads = 256;
constexpr int kMaxSharedBytes = 227 * 1024;

enum Mode { kMix = 0, kSel = 1, kSelB4 = 2, kSweep = 3 };

template <int OP>
__device__ __forceinline__ void issue_body(const int32_t* __restrict__ x,
                                           int reps,
                                           int32_t* __restrict__ out) {
  const int per_tile = kTile / kIssueThreads;
  const int64_t tile = blockIdx.x / per_tile;
  const int e = (blockIdx.x % per_tile) * kIssueThreads + threadIdx.x;
  uint32_t xs[kChains], a[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    xs[k] = static_cast<uint32_t>(x[k * kTile + e]) + k;
    a[k] = xs[k];
  }
#pragma unroll 4
  for (int r = 0; r < reps; ++r) {
    const uint32_t ru = static_cast<uint32_t>(r);
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (OP == 0) {
        a[k] += xs[k] ^ ru;
      } else {
        a[k] = static_cast<int32_t>(a[k]) > static_cast<int32_t>(xs[k])
                   ? a[k] - xs[k]
                   : a[k] + ru;
      }
    }
  }
  uint32_t s = a[0];
#pragma unroll
  for (int k = 1; k < kChains; ++k) s += a[k];
  out[tile * kTile + e] = static_cast<int32_t>(s);
}

__device__ __forceinline__ void mad(uint32_t& acc, uint32_t a, uint32_t b) {
  asm("mad.lo.u32 %0, %1, %2, %0;" : "+r"(acc) : "r"(a), "r"(b));
}

template <int MODE>
__device__ __forceinline__ void mix_body(int reps,
                                         const int32_t* __restrict__ kw,
                                         const int32_t* __restrict__ c0,
                                         int64_t rows, int P, int rpb,
                                         uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int nr = static_cast<int>(rows - r0 < rpb ? rows - r0 : rpb);
  uint32_t* s_c = smem;
  uint32_t* s_kw = smem + static_cast<int64_t>(rpb) * P;
  const int64_t base = r0 * P;
  for (int64_t b = threadIdx.x; b < static_cast<int64_t>(nr) * P;
       b += blockDim.x) {
    s_c[b] = static_cast<uint32_t>(c0[base + b]);
    if (MODE != kSweep) s_kw[b] = static_cast<uint32_t>(kw[base + b]);
  }
  __syncthreads();

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    uint32_t b0 = 0, b1 = 0;
    for (int r = 0; r < reps; ++r) {
      if (MODE == kSweep) {
        const volatile uint32_t* vc = s_c;
#pragma unroll 4
        for (int i = 0; i < nr; ++i) b0 += vc[i * P + p];
      } else if (MODE == kSelB4) {
        uint32_t m[4], qs[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t t = static_cast<uint32_t>(r) * 4 + k;
          m[k] = (t * 128) & 0x3FFu;
          qs[k] = (t & 63) + 1;
        }
#pragma unroll 4
        for (int i = 0; i < nr; ++i) {
          const uint32_t c = s_c[i * P + p];
          const uint32_t k = s_kw[i * P + p];
          uint32_t upd = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t d = k - m[j];
            b0 += d < qs[j] ? c : 0u;
            b1 += d == qs[j] ? c : 0u;
            upd += d == qs[j];
          }
          s_c[i * P + p] = c + upd;
        }
      } else {
        const uint32_t m = (static_cast<uint32_t>(r) * 128) & 0x3FFu;
        const uint32_t qs = (static_cast<uint32_t>(r) & 63) + 1;
#pragma unroll 4
        for (int i = 0; i < nr; ++i) {
          const uint32_t c = s_c[i * P + p];
          const uint32_t d = s_kw[i * P + p] - m;
          const uint32_t below = d < qs;
          const uint32_t eq = d == qs;
          if (MODE == kMix) {
            mad(b0, c, below);
            mad(b1, c, eq);
          } else {
            b0 += below ? c : 0u;
            b1 += eq ? c : 0u;
          }
          s_c[i * P + p] = c + eq;
        }
      }
    }
    atomicAdd(&out[p], b0 + b1);
  }
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kIssueThreads, 8)
qvz_mb_issue_addxor(const int32_t* x, int reps, int32_t* out) {
  issue_body<0>(x, reps, out);
}

extern "C" __global__ void __launch_bounds__(kIssueThreads, 8)
qvz_mb_issue_cmpsel(const int32_t* x, int reps, int32_t* out) {
  issue_body<1>(x, reps, out);
}

#define QVZ_MB_MIX_KERNEL(name, mode)                                       \
  extern "C" __global__ void __launch_bounds__(1024, 2)                     \
  name(int reps, const int32_t* kw, const int32_t* c0, int64_t rows, int P, \
       int rpb, uint32_t* out) {                                            \
    mix_body<mode>(reps, kw, c0, rows, P, rpb, out);                        \
  }

QVZ_MB_MIX_KERNEL(qvz_mb_mix, kMix)
QVZ_MB_MIX_KERNEL(qvz_mb_sel, kSel)
QVZ_MB_MIX_KERNEL(qvz_mb_sel_b4, kSelB4)
QVZ_MB_MIX_KERNEL(qvz_mb_sweeponly, kSweep)

// Launches the issue kernel on `stream`: op 0 addxor, 1 cmpsel; x is the
// (8, 8, 128) int32 tile set, out (tiles, 8, 128) int32. Returns the first
// CUDA error of the launch.
extern "C" int qvz_microbench_issue(const int32_t* x, int op, int reps,
                                    int tiles, int32_t* out, void* stream) {
  if (tiles <= 0 || reps < 0 || (op != 0 && op != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>(tiles) * (kTile / kIssueThreads);
  auto kernel = op == 0 ? qvz_mb_issue_addxor : qvz_mb_issue_cmpsel;
  kernel<<<blocks, kIssueThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, reps, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches a mix leg on `stream`: mode 0 mix, 1 sel, 2 sel_b4,
// 3 sweeponly. kw and c0: (rows, P) int32, P the product of the trailing
// axes; each block takes rpb rows, the last one the rest. out: (P,) int32,
// zeroed by the caller; the blocks' b0 + b1 are added into it mod 2^32.
extern "C" int qvz_microbench_mix(int mode, int reps, const int32_t* kw,
                                  const int32_t* c0, int64_t rows, int P,
                                  int rpb, int32_t* out, void* stream) {
  if (rows <= 0 || P <= 0 || rpb <= 0 || reps < 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem =
      static_cast<int64_t>(rpb) * P * 4 * (mode == kSweep ? 1 : 2);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernels[])(int, const int32_t*, const int32_t*, int64_t, int, int,
                    uint32_t*) = {qvz_mb_mix, qvz_mb_sel, qvz_mb_sel_b4,
                                  qvz_mb_sweeponly};
  auto kernel = kernels[mode];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((rows + rpb - 1) / rpb);
  const int threads = P < 1024 ? P : 1024;
  kernel<<<blocks, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      reps, kw, c0, rows, P, rpb, reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
