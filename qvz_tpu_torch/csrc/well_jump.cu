// KJ: the start states of the QVZ2 encode's WELL-1024a streams on the card.
//
// No TPU kernel counterpart. It replaces a host step of the encode: the
// GF(2) jump-ahead of every shard's start state on one host thread
// (pipeline/host.py shard_plan, rt.well_jump), in which each shard's state
// is reached from the one before it, and the upload of those states for KW
// (csrc/well.cu).
//
// What it computes. One word step of WELL-1024a is linear over GF(2) on
// the 1,024-bit state (n = 0 semantics: bit b of word w is vector bit
// 32 w + b), a matrix M; the state `offset` words on is M^offset v0. The
// host runtime keeps M^(2^k) for k = 0..63 (welljump::pow_table, exported
// by qvz_well_pow_table: 64 x 1,024 rows of 32 words, 8 MB), which the
// wrapper uploads once a card. Each stream's state is then the product of
// the table's matrices for the set bits of its own offset, applied to v0:
// no stream waits for another. Bit i of M v is the parity of row i AND v.
//
// What bounds it on an H100: operations. A product is 1,024 rows x 32
// words of AND-XOR (one LOP3 each) and a parity a row; about 8,200 streams
// of about 14 set bits each at 10M x 100 make 3.9 G such operations, 0.23
// ms on the ALU pipe. The bytes are the table's matrices read (128 KB
// each), the offsets and the states: a few MB. What the design does:
//   * One block of 1,024 threads a group of streams, one thread a row of
//     the matrix: for each bit that some stream of the group has set, each
//     thread loads its row of M^(2^k) into 32 registers once, then takes
//     every stream of the group with that bit set. So the table is read
//     once a block and bit, not once a product.
//   * The streams' states in shared memory, two buffers a stream (the
//     product reads one and writes the other; the parity of the offset's
//     bits below k says which holds the state before bit k). The state's
//     words are read by every thread at one address, a broadcast.
//   * A warp's 32 rows give one output word: each thread's parity is a
//     bit of __ballot_sync.
//   * Groups of about streams / SMs streams, so one block an SM.
//
// Shared memory: spb x (2 x 128 + 8) bytes (16,632 B at 63 streams a
// block).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 32;        // u32 words of a state or a matrix row
constexpr int kRows = 1024;       // rows of a matrix: one thread each
constexpr int kPowers = 64;       // the table's matrices, M^(2^k)
constexpr int kMaxStreams = 128;  // streams a block at most

struct State {
  uint32_t w[kWords];
};

// Streams blockIdx.x * spb .. + spb - 1: out + 32 j = M^offs[j] v0, from
// table (kPowers x kRows rows of kWords words, as uint4).
__global__ void __launch_bounds__(kRows, 1)
    well_jump_kernel(const uint4* __restrict__ table,
                     const int64_t* __restrict__ offs, int streams, int spb,
                     State v0, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];  // the states, then spb offsets
  __shared__ unsigned long long any;  // the OR of the group's offsets
  uint32_t* st = reinterpret_cast<uint32_t*>(smem);  // [2][spb][32]
  int64_t* off = reinterpret_cast<int64_t*>(st + 2 * spb * kWords);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int j0 = blockIdx.x * spb;
  const int nb = min(spb, streams - j0);
  if (t == 0) any = 0;
  __syncthreads();
  if (t < nb) {
    off[t] = offs[j0 + t];
    atomicOr(&any, static_cast<unsigned long long>(off[t]));
  }
  for (int i = t; i < nb * kWords; i += kRows) st[i] = v0.w[i & 31];
  __syncthreads();
  const unsigned long long bits = any;
#pragma unroll 1
  for (int k = 0; k < kPowers; ++k) {
    if (!((bits >> k) & 1)) continue;
    uint32_t r[kWords];
    const uint4* row = table + (static_cast<int64_t>(k) * kRows + t) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 x = __ldg(row + q);
      r[4 * q] = x.x;
      r[4 * q + 1] = x.y;
      r[4 * q + 2] = x.z;
      r[4 * q + 3] = x.w;
    }
    const unsigned long long below = (1ull << k) - 1;
#pragma unroll 1
    for (int s = 0; s < nb; ++s) {
      const unsigned long long o = off[s];
      if (!((o >> k) & 1)) continue;
      const int cur = __popcll(o & below) & 1;
      const uint4* v =
          reinterpret_cast<const uint4*>(st + (cur * spb + s) * kWords);
      uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint4 x = v[q];
        a0 ^= r[4 * q] & x.x;
        a1 ^= r[4 * q + 1] & x.y;
        a2 ^= r[4 * q + 2] & x.z;
        a3 ^= r[4 * q + 3] & x.w;
      }
      const uint32_t word =
          __ballot_sync(0xffffffffu, __popc(a0 ^ a1 ^ a2 ^ a3) & 1);
      if (lane == 0) st[((cur ^ 1) * spb + s) * kWords + warp] = word;
    }
    __syncthreads();
  }
  for (int i = t; i < nb * kWords; i += kRows) {
    const int s = i >> 5;
    const int cur = __popcll(static_cast<unsigned long long>(off[s])) & 1;
    out[static_cast<int64_t>(j0) * kWords + i] =
        st[(cur * spb + s) * kWords + (i & 31)];
  }
}

}  // namespace

// Launches KJ on `stream` on the current device: out + 32 j (u32, on the
// card) = the WELL-1024a state offs[j] words after v0 (32 words, n = 0
// semantics, on the host), for j < streams; offs (streams,) int64 on the
// card, non-negative; table the qvz_well_pow_table words on the card,
// 16-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int qvz_well_jump_states(const uint32_t* v0, const uint32_t* table,
                                    const int64_t* offs, int streams,
                                    uint32_t* out, void* stream) {
  if (streams <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int spb = std::min(kMaxStreams,
                           std::max(1, (streams + sms - 1) / std::max(sms, 1)));
  State s;
  std::copy(v0, v0 + kWords, s.w);
  const size_t smem = static_cast<size_t>(spb) *
                      (2 * kWords * sizeof(uint32_t) + sizeof(int64_t));
  well_jump_kernel<<<(streams + spb - 1) / spb, kRows, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(table), offs, streams, spb, s, out);
  return static_cast<int>(cudaGetLastError());
}
