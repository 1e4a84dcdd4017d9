// K5: lane-parallel adaptive arithmetic decoder, one thread per shard lane.
//
// Replaces the TPU kernel qvz_tpu/ops/decoder_pallas.py::_dkernel (entry
// decode_scan_tables, called from decoder_device.decode_lanes). Each lane is
// one QVZ2 shard: an independent adaptive arithmetic stream over its lines
// in column-major order. In that order the model of step (column c, line j)
// depends only on the symbol decoded at (c - 1, j), the line's cluster id
// and the dither draw, so a lane resolves each step's model from a row of
// its own previous-column symbols and never waits on another lane. The
// per-step maths is the host decoder's (qvz_rt.cpp Decoder::step,
// BitReader and ModelBank::update; reference src/arith.c:118-205,
// src/qv_stream.c:9-25): the tag check, the linear boundary search
// cum*range < (t - l + 1)*n, the exact floor(range*cum/n) bounds and the
// batched E1*/E3* renormalisation that takes stream bits MSB-first from
// the payload, zero-filled past its end. So the symbols are the host
// decoder's.
//
// What bounds it on an H100: latency, as K2. A lane is a strict sequential
// recurrence (interval, tag, bit position and counts), and only a few
// thousand lanes exist, so at most a few warps run per SM. Each step's
// chain is: load the previous symbol, cluster id and draw -> load the pair
// and its dither threshold -> load the model's slot base and cardinality
// -> sum the model's counts -> search them -> two 64-bit divides ->
// renormalise, reading payload bytes.
//
// What the design does about it, where the TPU kernel worked around
// Mosaic: the counts of a lane's current column live in a per-lane global
// scratch of S int32, reset from the initial bank at each column start (all
// lanes' scratch sits in the 50 MB L2); the search is the host's linear scan
// over the model's counts, not a bisection over lane-replicated tables; the
// products and divisions are exact 64-bit integer operations, not a split
// 20x22-bit product and an f32 division with fix-ups; the bit feed is a
// 64-bit reservoir over the lane's payload bytes that starts at any bit
// position (a cluster-id prologue ends mid-byte); the previous-column row
// is L bytes of device memory, with no cap on the lane length or the slot
// count. Card-1 models move neither the interval nor a bit and skip the
// search.
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
constexpr int kThreads = 32;
constexpr int64_t kFlagBad = 1, kFlagRescale = 2, kFlagOverrun = 4;

// MSB-first bits of one lane's payload, zero past its end (the host
// BitReader, started at any bit position).
struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t next = 0;  // next byte to load
  uint64_t acc = 0;  // upcoming bits at the high end
  int navail = 0;

  __device__ void refill() {
    uint64_t a = 0;
    for (int i = 0; i < 8; ++i) {
      const int64_t q = next + i;
      a = (a << 8) | (q < len ? data[q] : 0u);
    }
    acc = a;
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

__global__ void decode_lanes_kernel(
    const uint8_t* __restrict__ payload, const int64_t* __restrict__ pay_off,
    const int64_t* __restrict__ pay_len, const uint8_t* __restrict__ draws_t,
    int64_t n, const uint8_t* __restrict__ cl,
    const int64_t* __restrict__ lane_off, int lanes, int cols, int cols_run,
    const int32_t* __restrict__ ptab, int ptab_w,
    const int32_t* __restrict__ qrtab, const int32_t* __restrict__ slot_base,
    const int32_t* __restrict__ cards, const int32_t* __restrict__ init_counts,
    const int32_t* __restrict__ col_slots, const int32_t* __restrict__ symtab,
    int S, const int64_t* __restrict__ state_in, int32_t* __restrict__ counts,
    uint8_t* __restrict__ prev, uint8_t* __restrict__ out, int64_t row_stride,
    int sym_add, int64_t* __restrict__ state_out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= lanes) return;
  const int64_t lo = lane_off[w];
  const int64_t len = lane_off[w + 1] - lo;
  int32_t* cnt = counts + static_cast<int64_t>(w) * S;
  uint8_t* prv = prev + lo;
  BitReader br;
  br.data = payload + pay_off[w];
  br.len = pay_len[w];
  br.start(state_in[w * 4 + 3]);
  uint32_t l = static_cast<uint32_t>(state_in[w * 4 + 0]);
  uint32_t u = static_cast<uint32_t>(state_in[w * 4 + 1]);
  uint32_t t = static_cast<uint32_t>(state_in[w * 4 + 2]);
  bool bad = false, rescale = false;

  for (int c = 0; c < cols_run; ++c) {
    const int32_t* init = init_counts + static_cast<int64_t>(c) * S;
    const int ns = col_slots[c];
    for (int k = 0; k < ns; ++k) cnt[k] = init[k];
    const int32_t* prow = ptab + static_cast<int64_t>(c) * ptab_w;
    const uint8_t* drow = draws_t + static_cast<int64_t>(c) * n + lo;
    const int32_t* srow = symtab + static_cast<int64_t>(c) * S;
    uint8_t* orow = out + lo * row_stride;
    for (int64_t j = 0; j < len; ++j) {
      // model resolution: (cluster, previous symbol) -> pair -> dither
      const int pv = c ? prv[j] : 0;
      const int ci = cl ? cl[lo + j] : 0;
      int p = prow[ci * kAlphabet + pv];
      if (p < 0) {
        bad = true;
        p = 0;
      }
      const int m = 1 + 2 * p + (drow[j] >= qrtab[p] ? 1 : 0);
      const int sb = slot_base[m];
      const int card = cards[m];
      if (t < l || t > u) bad = true;
      int x = 0;
      if (card > 1) {
        int32_t* mc = cnt + sb;
        uint32_t total = 0;
        for (int k = 0; k < card; ++k) total += static_cast<uint32_t>(mc[k]);
        const uint64_t range = static_cast<uint64_t>(u) - l + 1u;
        const int64_t target =
            (static_cast<int64_t>(t) - static_cast<int64_t>(l) + 1) *
            static_cast<int64_t>(total);
        uint32_t cum = static_cast<uint32_t>(mc[0]);
        while (static_cast<int64_t>(cum * range) < target) {
          if (++x == card) {  // cum is the total: the tag left [l, u]
            x = card - 1;
            bad = true;
            break;
          }
          cum += static_cast<uint32_t>(mc[x]);
        }
        const uint32_t cum_lo = cum - static_cast<uint32_t>(mc[x]);
        rescale |= total + kStep > kArithR;
        mc[x] += static_cast<int32_t>(kStep);
        u = l + static_cast<uint32_t>(range * cum / total) - 1u;
        l = l + static_cast<uint32_t>(range * cum_lo / total);

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
      const int qv = srow[sb + x];
      prv[j] = static_cast<uint8_t>(qv);
      orow[j * row_stride + c] = static_cast<uint8_t>(qv + sym_add);
      if (c == 0 && row_stride > cols) orow[j * row_stride + cols] = '\n';
    }
  }

  const int64_t bits = br.consumed();
  const bool overrun = bits > 8 * (br.len + kOverrunBytes);
  state_out[w * 5 + 0] = l;
  state_out[w * 5 + 1] = u;
  state_out[w * 5 + 2] = t;
  state_out[w * 5 + 3] = bits;
  state_out[w * 5 + 4] = (bad ? kFlagBad : 0) | (rescale ? kFlagRescale : 0) |
                         (overrun ? kFlagOverrun : 0);
}

}  // namespace

// Launches K5 on `stream`; returns cudaGetLastError() of the launch.
// payload: every lane's bytes, lane w's at pay_off[w] for pay_len[w];
// draws_t: (cols, n) uint8; cl: (n,) uint8 cluster ids, or null with one
// cluster; lane_off: (lanes + 1,) int64 line offsets; ptab: (cols, ptab_w)
// int32; symtab, init_counts: (cols, S) int32; state_in: (lanes, 4) int64
// (l, u, t, consumed bits); counts: (lanes, S) int32 scratch; prev: (n,)
// uint8 scratch; out: (n, row_stride) uint8, row_stride >= cols;
// state_out: (lanes, 5) int64 (l, u, t, consumed bits, flags).
extern "C" int qvz_decode_lanes(
    const uint8_t* payload, const int64_t* pay_off, const int64_t* pay_len,
    const uint8_t* draws_t, int64_t n, const uint8_t* cl,
    const int64_t* lane_off, int lanes, int cols, int cols_run,
    const int32_t* ptab, int ptab_w, const int32_t* qrtab,
    const int32_t* slot_base, const int32_t* cards,
    const int32_t* init_counts, const int32_t* col_slots,
    const int32_t* symtab, int S, const int64_t* state_in, int32_t* counts,
    uint8_t* prev, uint8_t* out, int64_t row_stride, int sym_add,
    int64_t* state_out, void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  decode_lanes_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      payload, pay_off, pay_len, draws_t, n, cl, lane_off, lanes, cols,
      cols_run, ptab, ptab_w, qrtab, slot_base, cards, init_counts, col_slots,
      symtab, S, state_in, counts, prev, out, row_stride, sym_add, state_out);
  return static_cast<int>(cudaGetLastError());
}
