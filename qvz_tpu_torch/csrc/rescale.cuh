// The exact model rescale of the lane coder (K2a, coder.cu) and the lane
// decoder (K5, decoder.cu): the host's ModelBank::update (qvz_rt.cpp;
// reference src/qv_stream.c:9-25). A step codes its symbol with the
// model's counts and total; then c[x] += 8 and n = total + 8, and where n >
// 2^19 every count becomes (c >> 1) + 1 and n their sum. So the step that
// passes the limit codes with the counts from before the halving.
//
// A kernel keeps a lane's count of a slot as its column's initial count +
// 8 x the lane's uses of the slot (u16 in shared memory), and a model's
// total as the initial total + 8 x its uses. A model "at risk" is one whose
// initial total + 8 x the longest lane passes 2^19: only such a model can
// rescale inside a lane, and the caller marks them when it plans a launch
// (coder_device.risk_tables). Each lane holds, for each model at risk of
// the column, a record in device memory of its own: rec[0] = (total, 0),
// rec[1 + i] = (prefix, base) of the model's slot i, the counts that stand
// in for the column's initial tables. At the column start the block fills
// the records from those tables (fill_records); a step of a model at risk
// reads count = base + 8 x uses, total = rec total + 8 x the model's uses,
// and a rescale halves the record and restarts the uses (rescale_record).
// A later rescale halves it again.
//
// The u16 uses cannot wrap: a model not at risk takes at most (2^19 - 2) /
// 8 < 65,536 uses in a lane; a model at risk rescales before its total
// passes 2^19, so before its uses since the column start or the last
// rescale reach 65,536.
//
// The cluster-id model (model 0), which K2s (coder.cu) and K5p
// (decoder.cu) run one thread a lane, is updated once a line and keeps
// its full counts instead: card u32 a lane in shared memory, interleaved
// by lane (count k of the thread's lane at c[k x stride], stride the
// block's threads, so a warp's loads fall on distinct banks), loaded by
// load_counts and updated by update_counts.

#pragma once

#include <cstdint>

namespace qvz_rescale {

constexpr uint32_t kLimit = 1u << 19;  // a total above this rescales
constexpr uint32_t kStep = 8;
constexpr uint32_t kTotalMask = (1u << 20) - 1u;  // model record: card << 20

// The rescale of one model in a lane's record after the step's update
// (occ, the lane's uses of the model's slots, already counts the step):
// every count c = base + 8 x uses becomes (c >> 1) + 1, each slot's prefix
// the halved counts below it, the total their sum; the uses restart at 0.
// The caller zeroes the model's uses.
__device__ __forceinline__ void rescale_record(int2* rec, uint16_t* occ,
                                               uint32_t card) {
  uint32_t run = 0;
#pragma unroll 1
  for (uint32_t i = 0; i < card; ++i) {
    const uint32_t c =
        ((static_cast<uint32_t>(rec[1 + i].y) + kStep * occ[i]) >> 1) + 1u;
    rec[1 + i] = make_int2(static_cast<int>(run), static_cast<int>(c));
    run += c;
    occ[i] = 0;
  }
  rec[0] = make_int2(static_cast<int>(run), 0);
}

// The records of a block's nl lanes at a column start, all threads of the
// block: lane k's rn entries at rec + k x stride. src: the column's record
// sources, a slot s (>= 0: (ipr[s], ini[s]), or (0, ini[s]) where ipr is
// null) or -1 - the column-local model (its record's head: (its initial
// total, 0)); mt, ini and ipr: the column's model records, initial counts
// and prefixes.
__device__ __forceinline__ void fill_records(
    int2* rec, int64_t stride, int nl, int rn, const int32_t* src,
    const int2* mt, const int32_t* ini, const int32_t* ipr, int tid,
    int nthreads) {
#pragma unroll 1
  for (int i = tid; i < nl * rn; i += nthreads) {
    const int k = i / rn, p = i - k * rn;
    const int v = __ldg(src + p);
    rec[k * stride + p] =
        v >= 0 ? make_int2(ipr ? ipr[v] : 0, ini[v])
               : make_int2(static_cast<int>(
                               static_cast<uint32_t>(mt[-1 - v].y) &
                               kTotalMask),
                           0);
  }
}

// Model 0's initial counts into a lane's interleaved counts.
__device__ __forceinline__ void load_counts(uint32_t* c, int stride,
                                            const int32_t* init, int card) {
#pragma unroll 1
  for (int k = 0; k < card; ++k)
    c[k * stride] = static_cast<uint32_t>(__ldg(init + k));
}

// ModelBank::update of a lane's interleaved counts after a step of symbol
// x under `total`: c[x] += 8, and where total + 8 passes 2^19 every
// nonzero count becomes (c >> 1) + 1. Returns the new total.
__device__ __forceinline__ uint32_t update_counts(uint32_t* c, int stride,
                                                  int card, int x,
                                                  uint32_t total) {
  c[x * stride] += kStep;
  uint32_t n = total + kStep;
  if (n > kLimit) {
    n = 0;
#pragma unroll 1
    for (int k = 0; k < card; ++k) {
      const uint32_t v = c[k * stride];
      if (v) {
        c[k * stride] = (v >> 1) + 1u;
        n += (v >> 1) + 1u;
      }
    }
  }
  return n;
}

}  // namespace qvz_rescale
