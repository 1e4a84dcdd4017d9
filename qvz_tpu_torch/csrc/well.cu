// KW: the QVZ2 encode's WELL-1024a dither draws on the card.
//
// No TPU kernel counterpart. It replaces a host step of the encode: the
// threaded fill of every 7-bit draw of the file from the shards' jump-ahead
// start states (pipeline/host.py _shard_draws, rt.well_draws7 a shard),
// and the draws' 1 GB copy to the card and transpose there at 10M x 100.
// The start states still come from the host's GF(2) jump-ahead
// (host.shard_plan, rt.well_jump); KW writes every draw of a block of reads
// straight into the (cols, n) uint8 array that K1 reads.
//
// What it computes. A stream is a run of lines whose draws come, in (line,
// column) order, from one WELL-1024a stream started at its state (32
// words, index n = 0): Well::draw7 of native/qvz_rt.cpp (reference
// src/well.c:33-46). Every pool word gives four draws, its bits 0-6, 7-13,
// 14-20 and 21-27, and its last 4 bits are thrown away; a stream starts
// with an empty pool, and one whose lines x columns is not a multiple of 4
// ends inside a word. So draw d of a stream is bits 7 (d % 4) .. of its
// word d / 4. ops/well.py cuts a plan's shards into streams (each lane one
// stream, the warmup shard into lane-sized pieces at pool-word
// boundaries, so no stream is much longer than a lane).
//
// What bounds it on an H100: latency. A stream is a serial chain of words
// and only about 8,200 exist at 10M x 100 (two warps an SM), so the time is
// that of one thread's chain, not the 1.0 GB written (0.30 ms at 3.35 TB/s,
// the roofline) nor the 13 integer operations a word. What the design does
// about it:
//   * One thread a stream, its 32 state words in registers: the step is
//     unrolled 32 times, once for each value of the rotating index, so every
//     index into the state is a compile-time constant.
//   * The stores. Threads of a warp are streams a lane (1,216 lines) apart
//     and the output is column-major, so a thread that stored its own draws
//     would scatter single bytes. Instead each thread stages the words of
//     a tile of its stream in shared memory (a stream's slice of odd word
//     stride, so the warp's 32 stores of one step hit 32 banks); then the
//     warp, one thread a (stream, column), packs that column's draws of the
//     tile's lines and stores them as one piece. Words generated past a
//     tile's end carry over to the next.
//   * The tile's shape follows the width (Tiling): 16 lines of every column
//     (16-byte stores, 4-byte pieces where the address is only 4-aligned)
//     where one stream's 16 lines fit the block's shared memory, about
//     14,500 columns on the H100; else 4 lines (4-byte stores), about
//     58,000 columns; else one line in chunks of up to kChunk columns, so
//     that every width runs. Single bytes at a ragged end or an odd address.
//     A one-line tile may start inside a pool word (its phase).
//   * Columns that are a multiple of 4 (kQuad) put one line's four columns
//     in each word, so a column's draws share one shift: one shared load
//     and two operations a draw.
//
// Shared memory: spb streams x stride_words() words (55,424 B at 100
// columns and 32 streams a block).

#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStreams = 32;  // streams a block: one warp
constexpr int kChunk = 16384;    // columns a one-line tile holds at most
// the block's static shared memory: each stream's offset and lines
constexpr int64_t kStaticSmem = kMaxStreams * (sizeof(int64_t) + sizeof(int));

// Words one stream's slice of the staging buffer holds, for tiles of
// `lines` lines of `chunk` columns (chunk < cols only where lines is 1): a
// tile's draws from a phase of up to 3 and the 31 words a step makes past
// it, rounded up to an odd stride.
__host__ __device__ constexpr int stride_words(int lines, int cols,
                                               int chunk) {
  return ((((lines - 1) * cols + chunk + 6) >> 2) + 32) | 1;
}

// 32 steps of WELL-1024a from rotating index 0 back to 0 (Well::word),
// each output word to out[0..31].
__device__ __forceinline__ void words32(uint32_t (&s)[32], uint32_t* out) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = (32 - i) & 31;
    const int m = (n + 31) & 31;
    const uint32_t z0 = s[m];
    const uint32_t vm1 = s[(n + 3) & 31];
    const uint32_t vm2 = s[(n + 24) & 31];
    const uint32_t vm3 = s[(n + 10) & 31];
    const uint32_t z1 = s[n] ^ (vm1 ^ (vm1 >> 8));
    const uint32_t z2 = (vm2 ^ (vm2 << 19)) ^ (vm3 ^ (vm3 << 14));
    s[n] = z1 ^ z2;
    s[m] = (z0 ^ (z0 << 11)) ^ (z1 ^ (z1 << 7)) ^ (z2 ^ (z2 << 13));
    out[i] = s[m];
  }
}

// The `rows` (1..kLines) bytes of lo | hi << 64 to dst.
template <int kLines>
__device__ __forceinline__ void store_lines(uint8_t* dst, uint64_t lo,
                                            uint64_t hi, int rows) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (kLines == 16 && rows == kLines && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32),
                   static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32));
  } else if (kLines >= 4 && rows == kLines && (a & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    d[0] = static_cast<uint32_t>(lo);
    if (kLines == 16) {
      d[1] = static_cast<uint32_t>(lo >> 32);
      d[2] = static_cast<uint32_t>(hi);
      d[3] = static_cast<uint32_t>(hi >> 32);
    }
  } else {
    for (int l = 0; l < rows; ++l)
      dst[l] = static_cast<uint8_t>((l < 8 ? lo : hi) >> (8 * (l & 7)));
  }
}

// Streams blockIdx.x * spb .. + spb - 1, one a thread: stream j's lines
// offs[j] .. offs[j + 1] - 1 of out, (cols, n) uint8, from the 32 words of
// states + 32 j, in tiles of kLines lines of `chunk` columns (chunk is
// cols where kLines > 1). One warp a block.
template <bool kQuad, int kLines>
__global__ void __launch_bounds__(kMaxStreams)
    well_draws_kernel(const uint32_t* __restrict__ states,
                      const int64_t* __restrict__ offs, int streams, int cols,
                      int chunk, int64_t n, int spb,
                      uint8_t* __restrict__ out) {
  extern __shared__ uint32_t buf[];
  __shared__ int64_t base[kMaxStreams];
  __shared__ int len[kMaxStreams];
  const int lane = threadIdx.x;
  const int j0 = blockIdx.x * spb;
  const int nb = min(spb, streams - j0);
  const bool gen = lane < nb;
  int mine = 0;
  uint32_t s[32];
  if (gen) {
    base[lane] = offs[j0 + lane];
    mine = static_cast<int>(offs[j0 + lane + 1] - base[lane]);
    len[lane] = mine;
    const uint4* st =
        reinterpret_cast<const uint4*>(states + 32 * static_cast<int64_t>(
                                                         j0 + lane));
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint4 v = st[k];
      s[4 * k] = v.x;
      s[4 * k + 1] = v.y;
      s[4 * k + 2] = v.z;
      s[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) s[k] = 0;
  }
  const int lmax = __reduce_max_sync(0xffffffffu, mine);
  const int stride = stride_words(kLines, cols, chunk);  // odd: no conflicts
  uint32_t* my = buf + lane * stride;  // used only where gen
  int have = 0;                        // words staged, <= 32 between tiles
  int64_t at = 0;                      // each stream's draws before the tile
  __syncwarp();
#pragma unroll 1
  for (int l0 = 0; l0 < lmax; l0 += kLines) {
#pragma unroll 1
    for (int c0 = 0; c0 < cols; c0 += chunk) {
      const int cw = min(chunk, cols - c0);
      // the tile's draws run from draw `ph` of its first staged word (0
      // with kQuad) over (kLines - 1) x cols + cw draws
      const int ph = static_cast<int>(at & 3);
      const int span = (kLines - 1) * cols + cw;
#pragma unroll 1
      for (; have < (ph + span + 3) >> 2; have += 32)
        if (gen) words32(s, my + have);
      __syncwarp();
      int j = lane / cw;
      int c = lane - j * cw;  // from c0
#pragma unroll 1
      for (int p = lane; p < nb * cw; p += kMaxStreams) {
        const int rows = min(kLines, len[j] - l0);
        if (rows > 0) {
          const uint32_t* w = buf + j * stride;
          uint64_t lo = 0, hi = 0;
          if (kQuad) {
            const int q = cols >> 2;
            const int sh = 7 * (c & 3);
            const uint32_t* wc = w + (c >> 2);
#pragma unroll
            for (int l = 0; l < kLines; ++l) {
              const uint64_t b = (wc[l * q] >> sh) & 0x7Fu;
              if (l < 8) lo |= b << (8 * l);
              else hi |= b << (8 * (l - 8));
            }
          } else {
#pragma unroll
            for (int l = 0; l < kLines; ++l) {
              const int d = ph + l * cols + c;
              const uint64_t b = (w[d >> 2] >> (7 * (d & 3))) & 0x7Fu;
              if (l < 8) lo |= b << (8 * l);
              else hi |= b << (8 * (l - 8));
            }
          }
          store_lines<kLines>(
              out + static_cast<int64_t>(c0 + c) * n + base[j] + l0, lo, hi,
              rows);
        }
        c += kMaxStreams;
        while (c >= cw) {
          c -= cw;
          ++j;
        }
      }
      __syncwarp();
      // the words wholly used; a word the tile ends inside stays
      const int used = (ph + span) >> 2;
      have -= used;
      if (gen)
        for (int i = 0; i < have; ++i) my[i] = my[used + i];
      __syncwarp();
      at += span;
    }
  }
}

// The tile of a launch: kLines lines of `chunk` columns, spb streams a
// block.
struct Tiling {
  int lines, chunk, spb;
};

// The tile for `cols` columns in `avail` bytes of dynamic shared memory a
// block: the most lines of every column that one stream's slice holds;
// spb 0 where not even a one-line tile fits.
Tiling tiling(int cols, int64_t avail) {
  for (const int lines : {16, 4}) {
    const int64_t per = 4 * static_cast<int64_t>(stride_words(lines, cols,
                                                              cols));
    if (per <= avail)
      return {lines, cols, static_cast<int>(std::min<int64_t>(
                               kMaxStreams, avail / per))};
  }
  const int chunk = std::min(cols, kChunk);
  const int64_t per = 4 * static_cast<int64_t>(stride_words(1, cols, chunk));
  return {1, chunk,
          static_cast<int>(std::min<int64_t>(kMaxStreams, avail / per))};
}

template <bool kQuad, int kLines>
cudaError_t launch(const Tiling& t, int streams, cudaStream_t stream,
                   const uint32_t* states, const int64_t* offs, int cols,
                   int64_t n, uint8_t* out) {
  const auto kernel = well_draws_kernel<kQuad, kLines>;
  const int64_t smem =
      static_cast<int64_t>(t.spb) * stride_words(kLines, cols, t.chunk) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<(streams + t.spb - 1) / t.spb, kMaxStreams, smem, stream>>>(
      states, offs, streams, cols, t.chunk, n, t.spb, out);
  return cudaGetLastError();
}

template <int kLines>
cudaError_t launch_lines(const Tiling& t, int streams, cudaStream_t stream,
                         const uint32_t* states, const int64_t* offs,
                         int cols, int64_t n, uint8_t* out) {
  return cols % 4 == 0
             ? launch<true, kLines>(t, streams, stream, states, offs, cols, n,
                                    out)
             : launch<false, kLines>(t, streams, stream, states, offs, cols,
                                     n, out);
}

}  // namespace

// Launches KW on `stream` on the current device: the draws of `streams`
// streams into out, (cols, n) uint8, stream j's lines offs[j] .. offs[j +
// 1] - 1 (offs: (streams + 1,) int64, offs[0] = 0, offs[streams] = n,
// non-decreasing) from its start state states + 32 j (u32, 16-byte
// aligned). The tile and the streams a block follow from cols and the
// shared memory a block may ask for on the device. Returns
// cudaGetLastError() of the launch.
extern "C" int qvz_well_draws(const uint32_t* states, const int64_t* offs,
                              int streams, int cols, int64_t n, uint8_t* out,
                              void* stream) {
  if (streams <= 0 || n <= 0) return 0;
  if (cols < 1 || (reinterpret_cast<uintptr_t>(states) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Tiling t = tiling(cols, optin - kStaticSmem);
  if (t.spb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (t.lines) {
    case 16:
      e = launch_lines<16>(t, streams, st, states, offs, cols, n, out);
      break;
    case 4:
      e = launch_lines<4>(t, streams, st, states, offs, cols, n, out);
      break;
    default:
      e = launch_lines<1>(t, streams, st, states, offs, cols, n, out);
  }
  return static_cast<int>(e);
}
