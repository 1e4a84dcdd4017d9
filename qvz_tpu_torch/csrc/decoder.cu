// K5: lane-parallel adaptive arithmetic decoder, one thread per shard lane.
//
// Replaces the TPU kernel qvz_tpu/ops/decoder_pallas.py::_dkernel (entry
// decode_scan_tables, called from decoder_device.decode_lanes). Each lane is
// one QVZ2 shard: an independent adaptive arithmetic stream over its lines
// in column-major order. The per-step maths is the host decoder's
// (qvz_rt.cpp Decoder::step, BitReader and ModelBank::update; reference
// src/arith.c:118-205, src/qv_stream.c:9-25): the tag check, the linear
// boundary search cum*range < (t - l + 1)*n, the exact floor(range*cum/n)
// bounds and the batched E1*/E3* renormalisation that takes stream bits
// MSB-first from the payload, zero-filled past its end. So the symbols are
// the host decoder's.
//
// Bound. At 1M x 100 (3,894 lanes x 24,000 steps, -c 1 primed) it reads
// about 94 MB of draws and 30 MB of payload and writes 94 MB of text:
// 0.07 ms at 3.35 TB/s. Each step is on the order of 100 integer
// operations, about 9 G in all: 0.6 ms at 16.7 T int32 operations/s
// (132 SMs x 64 int32 lanes x 1.98 GHz). So operations bound the work; but
// a lane is a strict recurrence (interval, tag, bit position, counts) and
// only a few thousand lanes exist, so what holds a step is the latency of
// its dependent chain. The first version of this kernel spent about 2.6 us
// (5,000 cycles) a step on a chain through device memory and L2: the
// previous symbol, the pair, the dither threshold, the model's slot base and
// cardinality, its counts read twice from a per-lane L2 scratch (summed,
// then searched), two emulated 64-bit integer divides, and eight single-byte
// payload loads a refill; each column start reset S count slots one by one.
//
// What this design does about each link:
//   * Model resolution off the serial chain. The model of step (c, j)
//     depends only on the symbol at (c - 1, j), the line's cluster id and
//     the draw, so the whole block resolves a chunk of upcoming steps of
//     all its lanes in parallel (coalesced loads of draws, cluster ids and
//     the previous column's symbols) into a per-lane tile of column-local
//     model indices in shared memory. The serial loop reads one entry, and
//     prefetches the next step's entry and model record while it works.
//   * The column's tables in shared memory. The lanes of a block walk the
//     columns together; at each column start the block stages the
//     column's ptab row, model records (slot base, cardinality, initial
//     total), initial counts and symbol row with coalesced loads. A plan
//     too large for that (many clusters: S = 17,100 slots and a 43 KB
//     ptab row at -c 150) reads them from device memory instead, and one
//     where a lane's uses do not fit either keeps those in a device-memory
//     scratch (decode_lanes_kernel's kLayout), so K5 takes every plan.
//   * Counts and totals in shared memory. A lane's count of a slot is the
//     staged initial count + 8 x its uses in this column, a u16 per slot;
//     a model's total is its initial total + 8 x its uses, a u16 per
//     model, so the summing pass goes. The whole block zeroes them at each
//     column start with 16-byte stores. A u16 cannot wrap in a lane that
//     is not flagged: 65,535 uses of a live model give a total of at least
//     8 x 65,535 + 2 > 2^19 - 8, where the rescale flag is raised first.
//   * Exact division by a reciprocal: floor(a / n) with a = range x cum <
//     2^42 and n <= 2^19 is q = floor(a x rcp(n)) in f64, then one
//     correction: rcp is correctly rounded and the product adds one more
//     rounding, so |a x rcp(n) - a/n| <= 2^22 x 2^-51 = 2^-29. Where n does
//     not divide a, a/n lies at least 1/n >= 2^-19 from every integer, so
//     q is exact; where it does, q may be one short, and (q + 1) x n <= a
//     finds it. One reciprocal serves both bounds of a step.
//   * Wide payload reads: the reservoir refills with one aligned 8-byte
//     load, two where unaligned (the packed buffer is padded).
//   * Coalesced output: each chunk's symbols go to a shared tile, then to a
//     (cols, lines) buffer with neighbouring threads on neighbouring bytes;
//     a second kernel transposes that buffer into the text rows.
//   * Lanes a warp is a launch parameter (32, 16 or 8 of a warp's threads
//     decode; a block holds up to 32 lanes), so divergent steps of a warp
//     serialise fewer lanes and an SM interleaves more warps.
//
// Flag contract (as the JAX kernel): bad (the tag left [l, u], an
// unreachable context, or a search that ran past the model's last symbol,
// which happens only when the tag left [l, u]), rescale (a live model's
// total + 8 would pass 2^19, where the reference rescales) and overrun
// (more than 64 bytes consumed past the payload). The caller decodes a
// flagged lane again on the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kArithM = 22;
constexpr uint32_t kArithR = 1u << (kArithM - 3);
constexpr uint32_t kFull = (1u << kArithM) - 1u;
constexpr int kMsbShift = kArithM - 1;
constexpr int kSmsbShift = kArithM - 2;
constexpr uint32_t kMsbBit = 1u << kMsbShift;
constexpr uint32_t kMsbClear = kMsbBit - 1u;
constexpr uint32_t kStep = 8;
constexpr int kAlphabet = 72;
constexpr int kOverrunBytes = 64;
constexpr int kMaxLanesPerBlock = 32;
constexpr int64_t kFlagBad = 1, kFlagRescale = 2, kFlagOverrun = 4;

__device__ __forceinline__ uint64_t bswap64(uint64_t v) {
  const uint32_t lo = static_cast<uint32_t>(v);
  const uint32_t hi = static_cast<uint32_t>(v >> 32);
  return (static_cast<uint64_t>(__byte_perm(lo, 0, 0x0123)) << 32) |
         __byte_perm(hi, 0, 0x0123);
}

// MSB-first bits of one lane's payload, zero past its end (the host
// BitReader, started at any bit position). words: the packed payloads,
// 8-byte aligned, with at least 8 bytes after the last word that holds a
// payload byte.
struct BitReader {
  const uint64_t* words;
  int64_t base;      // the lane's first byte in the packed buffer
  int64_t len;
  int64_t next = 0;  // next byte to load
  uint64_t acc = 0;  // upcoming bits at the high end
  int navail = 0;

  __device__ void refill() {
    uint64_t v = 0;
    const int64_t rem = len - next;
    if (rem > 0) {
      const int64_t q = base + next;
      const int sh = static_cast<int>(q & 7) * 8;
      const uint64_t* w = words + (q >> 3);
      v = __ldg(w);
      if (sh) v = (v >> sh) | (__ldg(w + 1) << (64 - sh));
      v = bswap64(v);
      if (rem < 8) v &= ~0ull << (8 * (8 - rem));
    }
    acc = v;
    next += 8;
    navail = 64;
  }

  __device__ void start(int64_t bitpos) {
    next = bitpos >> 3;
    refill();
    const int s = static_cast<int>(bitpos & 7);
    acc <<= s;
    navail -= s;
  }

  // The next k bits, 0 <= k <= 32.
  __device__ uint32_t getk(int k) {
    uint32_t v;
    if (navail >= k) {
      v = static_cast<uint32_t>((acc >> 1) >> (63 - k));
      acc <<= k;
      navail -= k;
    } else {
      const int have = navail;
      v = have ? static_cast<uint32_t>(acc >> (64 - have)) : 0u;
      refill();
      const int need = k - have;
      v = (v << need) | static_cast<uint32_t>(acc >> (64 - need));
      acc <<= need;
      navail -= need;
    }
    return v;
  }

  __device__ int64_t consumed() const { return next * 8 - navail; }
};

// floor(a / n) for a < 2^53 with a / n <= 2^22, from r = rcp(n) (see the
// note at the top).
__device__ __forceinline__ uint32_t exact_div(uint64_t a, uint32_t n,
                                              double r) {
  uint64_t q = static_cast<uint64_t>(static_cast<double>(a) * r);
  if ((q + 1) * n <= a) ++q;
  return static_cast<uint32_t>(q);
}

// Where the column's tables and the lanes' uses live:
//   kLayout 0  both in shared memory (every plan of -c 1 and -c 3);
//   kLayout 1  the tables read from device memory through the read-only
//              cache, the uses in shared memory: a plan whose tables and
//              one lane's uses do not fit a block together (-c 150);
//   kLayout 2  the uses too in device memory, a scratch of lpb x (s_pad +
//              m_pad) u16 for each block of lanes: a plan where one lane's
//              uses alone do not fit. Every plan fits this layout.
// Dynamic shared memory, in this order (every size a multiple of 8 bytes):
//   mtab_s  int2[m_pad]           the column's model records       (0)
//   init_s  int32[s_pad]          the column's initial counts      (0)
//   ptab_s  int32[ptab_w]         the column's ptab row            (0)
//   occ     u16[lpb][s_pad]       each lane's uses of each slot    (0, 1)
//   muse    u16[lpb][m_pad]       each lane's uses of each model   (0, 1)
//   tile    u16[lpb][lt]          the chunk's column-local model indices
//   sym_s   u8[s_pad]             the column's symbol row          (0)
//   symt    u8[lpb][lt]           the chunk's decoded symbols
template <int kLayout>
__global__ void decode_lanes_kernel(
    const uint64_t* __restrict__ payload, const int64_t* __restrict__ pay_off,
    const int64_t* __restrict__ pay_len, const uint8_t* __restrict__ draws_t,
    int64_t n, const uint8_t* __restrict__ cl,
    const int64_t* __restrict__ lane_off, int lanes, int cols_run,
    const int32_t* __restrict__ ptab, int ptab_w,
    const int32_t* __restrict__ qrtab, const int32_t* __restrict__ mloc,
    const int2* __restrict__ mtab, const int32_t* __restrict__ col_model_off,
    const int32_t* __restrict__ init_counts,
    const int32_t* __restrict__ col_slots, const int32_t* __restrict__ symtab,
    int S, const int64_t* __restrict__ state_in, uint8_t* __restrict__ out_t,
    int64_t* __restrict__ state_out, uint16_t* __restrict__ scratch, int lpw,
    int lpb, int lt, int s_pad, int m_pad) {
  extern __shared__ uint4 smem_raw[];
  char* sp = reinterpret_cast<char*>(smem_raw);
  int2* mtab_s = reinterpret_cast<int2*>(sp);
  int32_t* init_s =
      reinterpret_cast<int32_t*>(sp + static_cast<size_t>(m_pad) * 8);
  int32_t* ptab_s = init_s + s_pad;
  if (kLayout == 0)
    sp += static_cast<size_t>(m_pad) * 8 + static_cast<size_t>(s_pad) * 4 +
          static_cast<size_t>(ptab_w) * 4;
  uint16_t* occ;
  if (kLayout < 2) {
    occ = reinterpret_cast<uint16_t*>(sp);
    sp += static_cast<size_t>(lpb) * (s_pad + m_pad) * 2;
  } else {
    occ = scratch + static_cast<size_t>(blockIdx.x) * lpb * (s_pad + m_pad);
  }
  uint16_t* muse = occ + static_cast<size_t>(lpb) * s_pad;
  uint16_t* tile = reinterpret_cast<uint16_t*>(sp);
  sp += static_cast<size_t>(lpb) * lt * 2;
  uint8_t* sym_s = reinterpret_cast<uint8_t*>(sp);
  if (kLayout == 0) sp += s_pad;
  uint8_t* symt = reinterpret_cast<uint8_t*>(sp);

  __shared__ int64_t lane_lo_s[kMaxLanesPerBlock];
  __shared__ int lane_len_s[kMaxLanesPerBlock];
  __shared__ int lane_bad_s[kMaxLanesPerBlock];  // an unreachable context
  __shared__ int block_len;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int w0 = blockIdx.x * lpb;
  const int nl = min(lpb, lanes - w0);  // lanes of this block
  if (tid == 0) block_len = 0;
  if (tid < kMaxLanesPerBlock) lane_bad_s[tid] = 0;
  __syncthreads();
  if (tid < nl) {
    const int64_t lo = lane_off[w0 + tid];
    const int len = static_cast<int>(lane_off[w0 + tid + 1] - lo);
    lane_lo_s[tid] = lo;
    lane_len_s[tid] = len;
    atomicMax(&block_len, len);
  }

  // this thread's lane, if it decodes one
  const int ll = (tid >> 5) * lpw + (tid & 31);
  const bool active = (tid & 31) < lpw && ll < nl;
  const int w = w0 + ll;
  BitReader br;
  uint32_t l = 0, u = 0, t = 0;
  bool bad = false, rescale = false;
  if (active) {
    br.words = payload;
    br.base = pay_off[w];
    br.len = pay_len[w];
    br.start(state_in[w * 4 + 3]);
    l = static_cast<uint32_t>(state_in[w * 4 + 0]);
    u = static_cast<uint32_t>(state_in[w * 4 + 1]);
    t = static_cast<uint32_t>(state_in[w * 4 + 2]);
  }
  __syncthreads();
  const int len_max = block_len;
  const int my_len = active ? lane_len_s[ll] : 0;
  uint16_t* my_occ = occ + static_cast<size_t>(ll) * s_pad;
  uint16_t* my_muse = muse + static_cast<size_t>(ll) * m_pad;
  const uint16_t* my_tile = tile + static_cast<size_t>(ll) * lt;
  uint8_t* my_symt = symt + static_cast<size_t>(ll) * lt;

  for (int c = 0; c < cols_run; ++c) {
    // -- stage the column and reset the lanes' uses ------------------------
    const int ns = col_slots[c];
    const int moff = col_model_off[c];
    const int mc = col_model_off[c + 1] - moff;
    const int nz = (ns + 7) >> 3, mz = (mc + 7) >> 3;
    for (int i = tid; i < nl * nz; i += nthreads) {
      reinterpret_cast<uint4*>(occ + static_cast<size_t>(i / nz) * s_pad)
          [i % nz] = make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < nl * mz; i += nthreads) {
      reinterpret_cast<uint4*>(muse + static_cast<size_t>(i / mz) * m_pad)
          [i % mz] = make_uint4(0, 0, 0, 0);
    }
    const int32_t* irow = init_counts + static_cast<int64_t>(c) * S;
    const int32_t* srow = symtab + static_cast<int64_t>(c) * S;
    const int32_t* prow = ptab + static_cast<int64_t>(c) * ptab_w;
    if (kLayout == 0) {
      for (int i = tid; i < mc; i += nthreads) mtab_s[i] = mtab[moff + i];
      for (int i = tid; i < ns; i += nthreads) {
        init_s[i] = irow[i];
        sym_s[i] = static_cast<uint8_t>(srow[i]);
      }
      for (int i = tid; i < ptab_w; i += nthreads) ptab_s[i] = prow[i];
    }
    __syncthreads();
    const int2* mt = kLayout == 0 ? mtab_s : mtab + moff;
    const int32_t* ini = kLayout == 0 ? init_s : irow;
    const int32_t* ptb = kLayout == 0 ? ptab_s : prow;

    const uint8_t* drow = draws_t + static_cast<int64_t>(c) * n;
    const uint8_t* prev_row =
        c ? out_t + static_cast<int64_t>(c - 1) * n : out_t;
    uint8_t* orow = out_t + static_cast<int64_t>(c) * n;
    for (int j0 = 0; j0 < len_max; j0 += lt) {
      // -- resolve the chunk's models, all lanes in parallel ---------------
      for (int i = tid; i < nl * lt; i += nthreads) {
        const int k = i / lt, jj = i - k * lt;
        if (j0 + jj >= lane_len_s[k]) continue;
        const int64_t line = lane_lo_s[k] + j0 + jj;
        const int pv = c ? prev_row[line] : 0;
        const int ci = cl ? cl[line] : 0;
        int p = ptb[ci * kAlphabet + pv];
        if (p < 0) {
          lane_bad_s[k] = 1;
          p = 0;
        }
        const int m = 1 + 2 * p + (drow[line] >= __ldg(qrtab + p) ? 1 : 0);
        tile[i] = static_cast<uint16_t>(__ldg(mloc + m));
      }
      __syncthreads();

      // -- the serial steps, one thread a lane -----------------------------
      const int steps = active ? min(lt, my_len - j0) : 0;
      uint32_t ml_next = steps > 0 ? my_tile[0] : 0;
      int2 mi_next = steps > 0 ? mt[ml_next] : make_int2(0, 0);
      for (int jj = 0; jj < steps; ++jj) {
        const uint32_t ml = ml_next;
        const int2 mi = mi_next;
        if (jj + 1 < steps) {
          ml_next = my_tile[jj + 1];
          mi_next = mt[ml_next];
        }
        const int sb = mi.x;
        const uint32_t card = static_cast<uint32_t>(mi.y) >> 20;
        if (t < l || t > u) bad = true;
        int x = 0;
        if (card > 1) {
          uint16_t* oc = my_occ + sb;
          const int32_t* ic = ini + sb;
          uint16_t& mu = my_muse[ml];
          const uint32_t total =
              (static_cast<uint32_t>(mi.y) & 0xFFFFFu) + kStep * mu;
          const uint64_t range = static_cast<uint64_t>(u) - l + 1u;
          const int64_t target =
              (static_cast<int64_t>(t) - static_cast<int64_t>(l) + 1) *
              static_cast<int64_t>(total);
          uint32_t cx = static_cast<uint32_t>(ic[0]) + kStep * oc[0];
          uint32_t cum = cx;
          while (static_cast<int64_t>(cum * range) < target) {
            if (++x == static_cast<int>(card)) {  // the tag left [l, u]
              x = card - 1;
              bad = true;
              break;
            }
            cx = static_cast<uint32_t>(ic[x]) + kStep * oc[x];
            cum += cx;
          }
          const uint32_t cum_lo = cum - cx;
          rescale |= total + kStep > kArithR;
          oc[x] += 1;
          mu += 1;
          const double r = __drcp_rn(static_cast<double>(total));
          u = l + exact_div(range * cum, total, r) - 1u;
          l = l + exact_div(range * cum_lo, total, r);

          // E1* batch: the k1 shared leading bits shift out; the tag takes
          // k1 stream bits. diff == 0 only in a lane already flagged; clamp
          // so the shifts stay defined.
          const uint32_t diff = l ^ u;
          if ((diff >> kMsbShift) == 0) {
            const int k1 = min(__clz(diff << (32 - kArithM)), kArithM);
            l = (l << k1) & kFull;
            u = ((u << k1) | ((1u << k1) - 1u)) & kFull;
            t = ((t << k1) | br.getk(k1)) & kFull;
          }
          // E3* batch: k3 straddle steps, one final MSB flip of the tag.
          if ((l >> kSmsbShift) == 1u && (u >> kSmsbShift) == 2u) {
            const uint32_t lx = l << (32 - kSmsbShift);
            const uint32_t ux = u << (32 - kSmsbShift);
            const int lrun = __clz(~lx | 1u);
            const int zrun = ux ? __clz(ux) : 32;
            const int k3 = 1 + min(lrun, zrun);
            l = (l << k3) & kMsbClear;
            u = (((u << k3) & kMsbClear) | kMsbBit) | ((1u << k3) - 1u);
            t = (((t << k3) | br.getk(k3)) & kFull) ^ kMsbBit;
          }
        }
        my_symt[jj] = kLayout == 0 ? sym_s[sb + x]
                                   : static_cast<uint8_t>(srow[sb + x]);
      }
      __syncthreads();

      // -- the chunk's symbols to the (cols, lines) buffer, coalesced ------
      for (int i = tid; i < nl * lt; i += nthreads) {
        const int k = i / lt, jj = i - k * lt;
        if (j0 + jj < lane_len_s[k]) orow[lane_lo_s[k] + j0 + jj] = symt[i];
      }
      // the next chunk's resolution writes only the tile, which the serial
      // steps no longer read; the next serial steps write symt only after
      // the barrier that follows it
    }
    __syncthreads();  // the column's symbols are out before the next stage
  }

  if (active) {
    bad |= lane_bad_s[ll] != 0;
    const int64_t bits = br.consumed();
    const bool overrun = bits > 8 * (br.len + kOverrunBytes);
    state_out[w * 5 + 0] = l;
    state_out[w * 5 + 1] = u;
    state_out[w * 5 + 2] = t;
    state_out[w * 5 + 3] = bits;
    state_out[w * 5 + 4] = (bad ? kFlagBad : 0) |
                           (rescale ? kFlagRescale : 0) |
                           (overrun ? kFlagOverrun : 0);
  }
}

// Text rows from the (cols, n) symbol buffer: out[line, c] = sym + sym_add
// for c < cols_run and lines [lo, hi), and a newline at column `cols` where
// the rows have one more column. A 32 x 32 tile a block: reads run along
// lines, writes along a row's bytes.
__global__ void text_rows_kernel(const uint8_t* __restrict__ out_t, int64_t n,
                                 int64_t lo, int64_t hi, int cols_run,
                                 int cols, uint8_t* __restrict__ out,
                                 int64_t row_stride, int sym_add) {
  __shared__ uint8_t tile[32][33];
  const int c0 = blockIdx.y * 32;
  const int64_t l0 = lo + static_cast<int64_t>(blockIdx.x) * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i;
    const int64_t line = l0 + threadIdx.x;
    if (c < cols_run && line < hi)
      tile[i][threadIdx.x] = out_t[static_cast<int64_t>(c) * n + line];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int64_t line = l0 + i;
    const int c = c0 + threadIdx.x;
    if (line >= hi) continue;
    if (c < cols_run)
      out[line * row_stride + c] =
          static_cast<uint8_t>(tile[threadIdx.x][i] + sym_add);
    if (row_stride > cols && blockIdx.y == 0 && threadIdx.x == 0)
      out[line * row_stride + cols] = '\n';
  }
}

}  // namespace

template <int kLayout, typename... Args>
cudaError_t launch_decode(int blocks, int threads, int64_t smem_bytes,
                          cudaStream_t stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      decode_lanes_kernel<kLayout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return e;
  decode_lanes_kernel<kLayout><<<blocks, threads, smem_bytes, stream>>>(
      args...);
  return cudaGetLastError();
}

// The shared memory one block may ask for on the current device.
extern "C" int qvz_decoder_smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return v;
}

// Launches K5 and its text-row kernel on `stream`; returns
// cudaGetLastError() after the launches. payload: the packed lane bytes
// (8-byte aligned, padded), lane w's at pay_off[w] for pay_len[w]; draws_t:
// (cols, n) uint8; cl: (n,) uint8 cluster ids, or null with one cluster;
// lane_off: (lanes + 1,) int64 line offsets; ptab: (cols, ptab_w) int32;
// mloc: (n_models,) int32 column-local model index; mtab: each column's
// model records (slot base, cardinality << 20 | initial total) from
// col_model_off[c]; init_counts, symtab: (cols, S) int32; state_in: (lanes,
// 4) int64 (l, u, t, consumed bits); out_t: (cols, n) uint8 scratch; out:
// (n, row_stride) uint8 text rows, row_stride >= cols; state_out: (lanes,
// 5) int64 (l, u, t, consumed bits, flags). lpw lanes decode in each warp,
// lpb lanes in each block (<= 32), lt steps a chunk, in `layout` 0, 1 or 2
// (decode_lanes_kernel); smem_bytes is the dynamic shared memory of that
// shape; scratch: for layout 2, ceil(lanes / lpb) x lpb x (s_pad + m_pad)
// u16 of device memory, else unused.
extern "C" int qvz_decode_lanes(
    const uint64_t* payload, const int64_t* pay_off, const int64_t* pay_len,
    const uint8_t* draws_t, int64_t n, const uint8_t* cl,
    const int64_t* lane_off, int lanes, int cols, int cols_run,
    const int32_t* ptab, int ptab_w, const int32_t* qrtab,
    const int32_t* mloc, const int2* mtab, const int32_t* col_model_off,
    const int32_t* init_counts, const int32_t* col_slots,
    const int32_t* symtab, int S, const int64_t* state_in, uint8_t* out_t,
    uint8_t* out, int64_t row_stride, int sym_add, int64_t* state_out,
    int layout, uint16_t* scratch, int lpw, int lpb, int lt, int s_pad,
    int m_pad, int64_t smem_bytes, int64_t line_lo, int64_t line_hi,
    void* stream) {
  if (lanes <= 0) return 0;
  if (lpw < 1 || lpw > 32 || lpb < 1 || lpb > kMaxLanesPerBlock ||
      layout < 0 || layout > 2 || (layout == 2 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = (lpb + lpw - 1) / lpw;
  const int blocks = (lanes + lpb - 1) / lpb;
#define QVZ_DECODE_ARGS                                                      \
  payload, pay_off, pay_len, draws_t, n, cl, lane_off, lanes, cols_run,      \
      ptab, ptab_w, qrtab, mloc, mtab, col_model_off, init_counts,           \
      col_slots, symtab, S, state_in, out_t, state_out, scratch, lpw, lpb,   \
      lt, s_pad, m_pad
  cudaError_t e;
  if (layout == 0)
    e = launch_decode<0>(blocks, 32 * warps, smem_bytes, st, QVZ_DECODE_ARGS);
  else if (layout == 1)
    e = launch_decode<1>(blocks, 32 * warps, smem_bytes, st, QVZ_DECODE_ARGS);
  else
    e = launch_decode<2>(blocks, 32 * warps, smem_bytes, st, QVZ_DECODE_ARGS);
#undef QVZ_DECODE_ARGS
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cols_run > 0 && line_hi > line_lo) {
    const dim3 grid(static_cast<unsigned>((line_hi - line_lo + 31) / 32),
                    static_cast<unsigned>((cols_run + 31) / 32));
    text_rows_kernel<<<grid, dim3(32, 8), 0, st>>>(
        out_t, n, line_lo, line_hi, cols_run, cols, out, row_stride,
        sym_add);
  }
  return static_cast<int>(cudaGetLastError());
}
