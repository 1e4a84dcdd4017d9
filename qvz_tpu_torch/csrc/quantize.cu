// K1: dithered context quantization of every read, four adjacent reads a
// thread.
//
// Replaces the TPU kernels qvz_tpu/ops/quantize_pallas.py::_qkernel_merged
// (the merged single-sweep form, the device default) and ::_qkernel (the
// split two-pass form). Both compute the semantics of
// qvz_tpu/ops/quantize.py::_quantize_device, which this kernel follows:
// per read, per column in order,
//
//   ctx    = ctxmap[(cl*cols + c)*72 + prev]
//   p      = pair_base[cl*cols + c] + ctx
//   pc     = 2p + (draw >= qratio[p])
//   qs, qv = qs_map[pc*72 + x], qv_map[pc*72 + x]
//   mid    = 1 + pc,  prev = qv
//
// What bounds it on an H100: device-memory bytes. Each symbol reads 2 B
// (the raw symbol and its 7-bit dither draw) and writes 12 B (three int32
// outputs, kept int32 so the coder and the tests compare like with like).
//
// What the design does about it:
// - Wide requests. A thread takes 4 adjacent reads of the (cols, N)
//   column-major arrays: per column one 4-byte word each of data_t and
//   draws_t and one 16-byte store per output.
// - A short chain. The host runtime folds the tables into two as it
//   builds them (native/qvz_rt.cpp, Tables): ctx2 (a u32 a (cluster,
//   column, prev): the context, and the pair's qratio in bits 8-15) and
//   qsv (a u16 a (pair, choice, symbol): qs, and qv in the high byte). A
//   column of a read is two dependent gathers, ctx2 then qsv, and the
//   thread's four reads are four independent chains.
// - The inputs ahead of the chain. The block (2,048 reads) walks the
//   columns in step through a ring of kStages slots in shared memory, one
//   barrier a column: while column c is computed, the 16-byte cp.async
//   copies of the block's data and draws of columns c + 1 .. c + kStages
//   - 1 are in flight. ctx2 and qsv are gathered from device memory
//   through the read-only cache: staging a column's tables in shared
//   memory as well measured no faster at -c 1 and slower at -c 3 on the
//   H100 (PERF.md), since every block copies them from L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kAlphabet = 72;
constexpr int kThreads = 512;
constexpr int kReads = 4;
constexpr int kBlockReads = kThreads * kReads;
constexpr int kInputBytes = 2 * kBlockReads;  // data and draws of a column
constexpr int kStages = 4;

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const uint8_t* __restrict__ data_t,
                    const uint8_t* __restrict__ draws_t,
                    const uint8_t* __restrict__ clusters, int64_t n,
                    int cols, const uint32_t* __restrict__ ctx2,
                    const int32_t* __restrict__ pair_bounds,
                    const uint16_t* __restrict__ qsv, int vec,
                    int32_t* __restrict__ mid, int32_t* __restrict__ qs,
                    int32_t* __restrict__ qv) {
  __shared__ __align__(16) uint8_t smem[kStages * kInputBytes];
  const int tid = threadIdx.x;
  const int64_t blk0 = static_cast<int64_t>(blockIdx.x) * kBlockReads;
  const int64_t i0 = blk0 + kReads * tid;

  // Column c's data and draws into slot c % kStages.
  auto stage = [&](int c) {
    uint8_t* s = smem + (c % kStages) * kInputBytes;
    const int64_t off = static_cast<int64_t>(c) * n;
    if (vec == 16) {
      constexpr int kPer = kBlockReads / 16;
#pragma unroll 1
      for (int q = tid; q < 2 * kPer; q += kThreads) {
        const int w = q / kPer;
        const int o = (q - w * kPer) * 16;
        const uint8_t* src = (w ? draws_t : data_t) + off;
        const int64_t r = blk0 + o;
        qvz_stage::copy16(s + w * kBlockReads + o, r < n ? src + r : src,
                          r < n ? 16 : 0);
      }
    } else {
      qvz_stage::rows(s, 0, data_t + off, n, 1, blk0, kBlockReads, vec, tid,
                      kThreads);
      qvz_stage::rows(s + kBlockReads, 0, draws_t + off, n, 1, blk0,
                      kBlockReads, vec, tid, kThreads);
    }
  };

  int cl[kReads], prev[kReads];
#pragma unroll
  for (int r = 0; r < kReads; ++r) {
    cl[r] = clusters != nullptr && i0 + r < n ? clusters[i0 + r] : 0;
    prev[r] = 0;
  }
  const bool full = vec >= 4 && i0 + kReads <= n;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < cols) stage(c);
    qvz_stage::commit();
  }
#pragma unroll 1
  for (int c = 0; c < cols; ++c) {
    qvz_stage::wait<kStages - 2>();
    __syncthreads();
    // the slot that column c + kStages - 1 takes was read in column c - 1,
    // which every thread has finished
    if (c + kStages - 1 < cols) stage(c + kStages - 1);
    qvz_stage::commit();

    const uint8_t* s = smem + (c % kStages) * kInputBytes;
    const uint32_t x4 = reinterpret_cast<const uint32_t*>(s)[tid];
    const uint32_t d4 =
        reinterpret_cast<const uint32_t*>(s + kBlockReads)[tid];
    int out_mid[kReads], out_qs[kReads], out_qv[kReads];
#pragma unroll
    for (int r = 0; r < kReads; ++r) {
      const int x = (x4 >> (8 * r)) & 0xff;
      const int draw = (d4 >> (8 * r)) & 0xff;
      const int cc = cl[r] * cols + c;
      const int pb = __ldg(pair_bounds + cc);
      const uint32_t e = __ldg(ctx2 + int64_t{cc} * kAlphabet + prev[r]);
      const int ctx = e & 0xff;
      const int choice = draw >= static_cast<int>(e >> 8) ? 1 : 0;
      const uint32_t v =
          __ldg(qsv + (int64_t{2} * (pb + ctx) + choice) * kAlphabet + x);
      out_mid[r] = 1 + 2 * (pb + ctx) + choice;
      out_qs[r] = v & 0xff;
      out_qv[r] = v >> 8;
      prev[r] = out_qv[r];
    }
    const int64_t o = static_cast<int64_t>(c) * n + i0;
    if (full) {
      *reinterpret_cast<int4*>(mid + o) =
          make_int4(out_mid[0], out_mid[1], out_mid[2], out_mid[3]);
      *reinterpret_cast<int4*>(qs + o) =
          make_int4(out_qs[0], out_qs[1], out_qs[2], out_qs[3]);
      *reinterpret_cast<int4*>(qv + o) =
          make_int4(out_qv[0], out_qv[1], out_qv[2], out_qv[3]);
    } else {
#pragma unroll
      for (int r = 0; r < kReads; ++r) {
        if (i0 + r < n) {
          mid[o + r] = out_mid[r];
          qs[o + r] = out_qs[r];
          qv[o + r] = out_qv[r];
        }
      }
    }
  }
}

}  // namespace

// Launches K1 on `stream`; returns the launch's CUDA error. clusters may
// be null (one cluster). ctx2: (n_clusters * cols * 72) u32, pair_bounds:
// (n_clusters * cols + 1) int32, qsv: (n_pairs * 2 * 72) u16, as
// ops/quantize.py::tables_to_torch gives them.
extern "C" int qvz_quantize(const uint8_t* data_t, const uint8_t* draws_t,
                            const uint8_t* clusters, int64_t n, int cols,
                            const uint32_t* ctx2, const int32_t* pair_bounds,
                            const uint16_t* qsv, int32_t* mid, int32_t* qs,
                            int32_t* qv, void* stream) {
  if (n <= 0 || cols <= 0) return 0;
  const int vec = n % 16 == 0 ? 16 : n % 4 == 0 ? 4 : 1;
  const int64_t blocks = (n + kBlockReads - 1) / kBlockReads;
  quantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      data_t, draws_t, clusters, n, cols, ctx2, pair_bounds, qsv, vec, mid,
      qs, qv);
  return static_cast<int>(cudaGetLastError());
}
