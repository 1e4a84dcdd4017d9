// Standalone sanitizer harness for qvz_tpu_torch's native runtime.
//
// Built by `make tsan-torch` / `make asan-torch` (see the top-level
// Makefile) as one executable that compiles qvz_rt.cpp with
// -fsanitize=thread or -fsanitize=address,undefined: ThreadSanitizer
// cannot instrument a ctypes-loaded library reliably, so the whole process
// is built. The Python pools release the interpreter lock inside every
// ctypes call, so the harness's threads stand in for them: each site calls
// the runtime from several threads where the package does, over one shared
// read-only Tables.
//
// Sites:
//   1. qvz_kmeans_iter: its own row threads over the whole buffer, and
//      chunk by chunk on slices of one buffer from concurrent threads
//      (the streamed and multi-host k-means), merged as exact integers;
//   2. qvz_well_jump (racing on the once-built power table) and
//      qvz_well_draws7 from concurrent threads;
//   3. qvz_design_create (its parallel_for), the tables from the design
//      and from the serialized blocks (the decoder's tables);
//   4. the tables' accessors, the folded qvz_tables_ctx2 and
//      qvz_tables_qsv among them, read by several threads and held
//      against a fold recomputed here;
//   5. qvz_encode_fused_colmajor / qvz_decode_colmajor /
//      qvz_decode_cluster_prologue, one thread a shard;
//   6. primed shard coding: a warmup bank captured serially, then read by
//      every shard's thread;
//   7. qvz_quantize_colmajor feeding qvz_encode_precomputed_colmajor with
//      and without a bank out, one thread a shard (the streamed encode and
//      the transcode), qvz_bank_from_stream, and the decoder's bank;
//   8. qvz_encode_lines (the v1 stream) and qvz_decode_lines, one thread a
//      shard;
//   9. qvz_replay_model past a rescale, from concurrent threads;
//  10. qvz_decode_colmajor, qvz_decode_cluster_prologue and
//      qvz_decode_lines on truncated and bit-flipped payloads, each in a
//      heap buffer of exactly its length: the bit reader's overrun guard
//      must return an error code, and never read past the buffer.
// Every site checks its result (round trips equal the symbols, banks and
// payloads equal a serial run's), so the harness is also a small
// correctness gate. A failed check aborts with its line.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#include "qvz_rt.h"

namespace {

constexpr int A = 72;
constexpr uint64_t kLines = 6000;
constexpr uint32_t kCols = 40;
constexpr uint32_t kClusters = 2;

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      std::fprintf(stderr, "%s:%d: check failed: %s\n", __FILE__,      \
                   __LINE__, #cond);                                   \
      std::abort();                                                    \
    }                                                                  \
  } while (0)

void run_threads(int n, const std::function<void(int)>& fn) {
  std::vector<std::thread> ts;
  for (int t = 0; t < n; ++t) ts.emplace_back(fn, t);
  for (auto& th : ts) th.join();
}

// One shard of the file: lines [lo, lo + n), its WELL start state, its
// column-major symbols and cluster ids.
struct Shard {
  uint64_t lo = 0, n = 0;
  const uint32_t* state = nullptr;
  std::vector<uint8_t> data_t, cl;
};

std::vector<Shard> make_shards(const std::vector<uint8_t>& data,
                               const std::vector<uint8_t>& clusters,
                               const std::vector<uint64_t>& bounds,
                               const uint32_t* states) {
  std::vector<Shard> out(bounds.size() - 1);
  for (size_t s = 0; s + 1 < bounds.size(); ++s) {
    Shard& sh = out[s];
    sh.lo = bounds[s];
    sh.n = bounds[s + 1] - bounds[s];
    sh.state = states + 32 * s;
    sh.data_t.resize(sh.n * kCols);
    for (uint64_t i = 0; i < sh.n; ++i)
      for (uint32_t c = 0; c < kCols; ++c)
        sh.data_t[c * sh.n + i] = data[(sh.lo + i) * kCols + c];
    sh.cl.assign(clusters.begin() + sh.lo, clusters.begin() + sh.lo + sh.n);
  }
  return out;
}

int64_t payload_cap(uint64_t n) { return static_cast<int64_t>(n) * kCols * 2 + 4096; }

// The decoders' error codes: -1 a cluster id past the tables, -2 an
// unreachable context, -3 the tag left the interval, -4 overrun.
bool decode_status_ok(int32_t rc) { return rc == 0 || (rc >= -4 && rc <= -1); }

// A heap copy of exactly `len` bytes, so that ASan sees a read past it.
std::unique_ptr<uint8_t[]> exact_copy(const uint8_t* p, uint64_t len) {
  std::unique_ptr<uint8_t[]> b(new uint8_t[len ? len : 1]);
  if (len) std::memcpy(b.get(), p, len);
  return b;
}

}  // namespace

int main() {
  // Synthetic Illumina-like data: a random walk clipped to [0, 71].
  std::vector<uint8_t> data(kLines * kCols);
  uint64_t s = 0x9E3779B97F4A7C15ull;
  auto rnd = [&]() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  };
  for (uint64_t i = 0; i < kLines; ++i) {
    int v = 20 + static_cast<int>(rnd() % 25);
    for (uint32_t c = 0; c < kCols; ++c) {
      v += static_cast<int>(rnd() % 7) - 3;
      v = std::min(std::max(v, 0), 71);
      data[i * kCols + c] = static_cast<uint8_t>(v);
    }
  }
  std::vector<uint8_t> clusters(kLines);
  for (uint64_t i = 0; i < kLines; ++i)
    clusters[i] = static_cast<uint8_t>(rnd() % kClusters);

  // 1. k-means: the whole buffer, then slices of it from concurrent
  //    threads, merged; assignments, sums and counts must agree.
  {
    std::vector<int64_t> means(kClusters * kCols);
    for (uint32_t k = 0; k < kClusters; ++k)
      for (uint32_t c = 0; c < kCols; ++c)
        means[k * kCols + c] = data[(k * 97) * kCols + c];
    std::vector<uint8_t> assign(kLines);
    std::vector<int64_t> sums(kClusters * kCols), counts(kClusters);
    for (int it = 0; it < 3; ++it) {
      qvz_kmeans_iter(data.data(), kLines, kCols, means.data(), kClusters,
                      assign.data(), sums.data(), counts.data());
      for (uint32_t k = 0; k < kClusters; ++k)
        for (uint32_t c = 0; c < kCols && counts[k]; ++c)
          means[k * kCols + c] = sums[k * kCols + c] / counts[k];
    }
    qvz_kmeans_iter(data.data(), kLines, kCols, means.data(), kClusters,
                    assign.data(), sums.data(), counts.data());
    const std::vector<uint64_t> cut = {0, 2501, 4333, kLines};
    const int nch = static_cast<int>(cut.size()) - 1;
    std::vector<uint8_t> assign_c(kLines);
    std::vector<std::vector<int64_t>> psums(nch), pcounts(nch);
    run_threads(nch, [&](int t) {
      psums[t].resize(kClusters * kCols);
      pcounts[t].resize(kClusters);
      qvz_kmeans_iter(data.data() + cut[t] * kCols, cut[t + 1] - cut[t],
                      kCols, means.data(), kClusters,
                      assign_c.data() + cut[t], psums[t].data(),
                      pcounts[t].data());
    });
    CHECK(assign_c == assign);
    for (size_t j = 0; j < sums.size(); ++j) {
      int64_t m = 0;
      for (int t = 0; t < nch; ++t) m += psums[t][j];
      CHECK(m == sums[j]);
    }
    for (uint32_t k = 0; k < kClusters; ++k) {
      int64_t m = 0;
      for (int t = 0; t < nch; ++t) m += pcounts[t][k];
      CHECK(m == counts[k]);
    }
    std::printf("kmeans_iter whole and x%d concurrent chunks: ok\n", nch);
  }

  // 2. Concurrent well_jump (racing on the power-table build) and draws.
  uint32_t base_state[32];
  for (int i = 0; i < 32; ++i) base_state[i] = 0x55555555u;
  {
    const int nt = 8;
    std::vector<std::vector<uint32_t>> outs(nt), draws_in(nt);
    std::vector<std::vector<uint8_t>> draws(nt);
    run_threads(nt, [&](int t) {
      outs[t].resize(32 * 4);
      qvz_well_jump(base_state, 4, 1000 + 64ull * t, outs[t].data());
      draws[t].resize(4000 + 13 * t);
      qvz_well_draws7(outs[t].data() + 32, draws[t].size(), draws[t].data());
    });
    for (int t = 0; t < nt; ++t) {
      std::vector<uint32_t> ref(32 * 4);
      qvz_well_jump(base_state, 4, 1000 + 64ull * t, ref.data());
      CHECK(ref == outs[t]);
      std::vector<uint8_t> d(draws[t].size());
      qvz_well_draws7(ref.data() + 32, d.size(), d.data());
      CHECK(d == draws[t]);
    }
    std::printf("well_jump + well_draws7 x%d concurrent: ok\n", nt);
  }

  // 3. Threaded design; the encoder's tables and the decoder's, parsed
  //    from the serialized blocks.
  std::vector<uint64_t> c0(kClusters * A, 0);
  std::vector<uint64_t> cc(static_cast<size_t>(kClusters) * (kCols - 1) * A *
                               A,
                           0);
  qvz_stats(data.data(), kLines, kCols, clusters.data(), c0.data(),
            cc.data());
  std::vector<double> dist(A * A);
  for (int x = 0; x < A; ++x)
    for (int y = 0; y < A; ++y)
      dist[x + A * y] = static_cast<double>((x - y) * (x - y));
  void* design = qvz_design_create(c0.data(), cc.data(), kClusters, kCols,
                                   /*MODE_RATIO=*/0, 0.5, dist.data());
  void* enc_tb = qvz_tables_from_design(design);
  std::vector<uint8_t> blocks(qvz_design_serialized_size(design));
  qvz_design_serialized(design, blocks.data());
  void* dec_tb = qvz_tables_from_blocks(blocks.data(), blocks.size(),
                                        kClusters, kCols);
  CHECK(dec_tb != nullptr);
  CHECK(qvz_tables_consumed(dec_tb) == static_cast<int64_t>(blocks.size()));
  CHECK(qvz_tables_n_models(dec_tb) == qvz_tables_n_models(enc_tb));
  const uint64_t bank_words = qvz_tables_bank_words(dec_tb);
  CHECK(bank_words == qvz_tables_bank_words(enc_tb));
  std::printf("design (threaded), tables from design and blocks: ok\n");

  // 4. The tables' accessors, read by several threads at once; the
  //    folded ctx2 and qsv against a fold recomputed from the plain maps.
  {
    run_threads(6, [&](int t) {
      void* tb = (t & 1) ? dec_tb : enc_tb;
      const uint64_t np = qvz_tables_n_pairs(tb);
      const uint32_t* pb = qvz_tables_pair_base(tb);
      const int32_t* cm = qvz_tables_ctxmap(tb);
      const uint8_t* qr = qvz_tables_qratio(tb);
      const uint8_t* qv = qvz_tables_qv_map(tb);
      const uint8_t* qs = qvz_tables_qs_map(tb);
      const uint32_t* ctx2 = qvz_tables_ctx2(tb);
      const uint16_t* qsv = qvz_tables_qsv(tb);
      const uint32_t* card = qvz_tables_model_card(tb);
      const uint64_t* off = qvz_tables_model_off(tb);
      const uint32_t nm = qvz_tables_n_models(tb);
      CHECK(off[nm] == qvz_tables_model_syms_len(tb));
      CHECK(qvz_tables_model_syms(tb) != nullptr);
      for (uint32_t m = 0; m < nm; ++m) CHECK(off[m + 1] - off[m] == card[m]);
      for (uint64_t k = 0; k < uint64_t{kClusters} * kCols; ++k)
        for (int prev = 0; prev < A; ++prev) {
          const int32_t ctx = std::max(cm[k * A + prev], 0);
          const uint64_t p = std::min<uint64_t>(pb[k] + ctx, np - 1);
          CHECK(ctx2[k * A + prev] ==
                (static_cast<uint32_t>(ctx) | uint32_t{qr[p]} << 8));
        }
      for (uint64_t i = 0; i < np * 2 * A; ++i)
        CHECK(qsv[i] == (qs[i] | qv[i] << 8));
    });
    std::printf("tables ctx2/qsv x6 concurrent readers: ok\n");
  }

  // Shards of the QVZ2 shape: four, each on a multiple of 4 lines (a WELL
  // pool-word boundary), the last one ragged.
  const int n_shards = 4;
  std::vector<uint32_t> states(static_cast<size_t>(n_shards) * 32);
  const uint64_t per = ((kLines + n_shards - 1) / n_shards + 3) & ~3ull;
  qvz_well_jump(base_state, n_shards, per * kCols / 4, states.data());
  std::vector<uint64_t> bounds;
  for (int t = 0; t <= n_shards; ++t)
    bounds.push_back(std::min<uint64_t>(kLines, t * per));
  const std::vector<Shard> shards =
      make_shards(data, clusters, bounds, states.data());

  // 5. One fused encode + decode + cluster prologue thread a shard.
  std::vector<std::vector<uint8_t>> fused_pay(n_shards), fused_recon(n_shards);
  std::vector<double> fused_d(n_shards);
  run_threads(n_shards, [&](int t) {
    const Shard& sh = shards[t];
    const uint64_t n = sh.n;
    fused_recon[t].resize(kCols * n);
    std::vector<uint8_t> pay(payload_cap(n));
    const int64_t r = qvz_encode_fused_colmajor(
        enc_tb, sh.data_t.data(), n, sh.cl.data(), sh.state, dist.data(),
        fused_recon[t].data(), &fused_d[t], pay.data(), pay.size(), nullptr,
        nullptr);
    CHECK(r > 0);
    pay.resize(r);
    fused_pay[t] = pay;
    CHECK(qvz_xxh64(pay.data(), pay.size(), 0) ==
          qvz_xxh64(pay.data(), pay.size(), 0));
    std::vector<uint8_t> out(n * (kCols + 1));
    std::vector<uint8_t> cl_out(n);
    const int32_t rc = qvz_decode_colmajor(dec_tb, pay.data(), r, n,
                                           sh.state, out.data(), nullptr,
                                           nullptr, cl_out.data(), nullptr);
    CHECK(rc == 0);
    CHECK(cl_out == sh.cl);
    for (uint64_t i = 0; i < n; ++i) {
      for (uint32_t c = 0; c < kCols; ++c)
        CHECK(out[i * (kCols + 1) + c] == fused_recon[t][c * n + i] + 33);
      CHECK(out[i * (kCols + 1) + kCols] == '\n');
    }
    std::vector<uint8_t> pcl(n);
    uint64_t pst[4];
    const int32_t pr = qvz_decode_cluster_prologue(
        dec_tb, pay.data(), static_cast<uint64_t>(r), n, nullptr, pcl.data(),
        pst);
    CHECK(pr == 0);
    CHECK(pcl == sh.cl);
    CHECK(pst[0] <= pst[2] && pst[2] <= pst[1]);
    CHECK(pst[3] >= 22);
  });
  std::printf("sharded fused encode + decode + prologue x%d threads: ok\n",
              n_shards);

  // 6. Primed shard coding: shard 0 captures the bank serially, then
  //    every other shard reads that one snapshot concurrently.
  std::vector<uint32_t> warm_bank(bank_words);
  {
    std::vector<uint8_t> pay(payload_cap(shards[0].n));
    double d = 0;
    const int64_t r = qvz_encode_fused_colmajor(
        enc_tb, shards[0].data_t.data(), shards[0].n, shards[0].cl.data(),
        shards[0].state, dist.data(), nullptr, &d, pay.data(), pay.size(),
        nullptr, warm_bank.data());
    CHECK(r > 0);
    std::vector<uint8_t> out(shards[0].n * (kCols + 1));
    std::vector<uint32_t> dbank(bank_words);
    CHECK(qvz_decode_colmajor(dec_tb, pay.data(), r, shards[0].n,
                              shards[0].state, out.data(), nullptr,
                              dbank.data(), nullptr, nullptr) == 0);
    CHECK(dbank == warm_bank);
  }
  std::vector<std::vector<uint8_t>> primed_pay(n_shards);
  run_threads(n_shards - 1, [&](int t0) {
    const int t = t0 + 1;
    const Shard& sh = shards[t];
    std::vector<uint8_t> recon(kCols * sh.n);
    std::vector<uint8_t> pay(payload_cap(sh.n));
    double d = 0;
    const int64_t r = qvz_encode_fused_colmajor(
        enc_tb, sh.data_t.data(), sh.n, sh.cl.data(), sh.state, dist.data(),
        recon.data(), &d, pay.data(), pay.size(), warm_bank.data(), nullptr);
    CHECK(r > 0);
    pay.resize(r);
    primed_pay[t] = pay;
    std::vector<uint8_t> out(sh.n * (kCols + 1));
    CHECK(qvz_decode_colmajor(dec_tb, pay.data(), r, sh.n, sh.state,
                              out.data(), warm_bank.data(), nullptr, nullptr,
                              nullptr) == 0);
    for (uint64_t i = 0; i < sh.n; ++i)
      for (uint32_t c = 0; c < kCols; ++c)
        CHECK(out[i * (kCols + 1) + c] == recon[c * sh.n + i] + 33);
  });
  std::printf("primed shard coding x%d threads: ok\n", n_shards - 1);

  // 7. Quantize, then code the precomputed streams: serially first, then
  //    one thread a shard, with a bank out on every shard and the warmup
  //    bank in on the primed ones, on the decoder's tables (the
  //    transcode) and the encoder's (the streamed encode).
  std::vector<std::vector<uint32_t>> model_t(n_shards);
  std::vector<std::vector<uint8_t>> qs_t(n_shards);
  {
    std::vector<std::vector<uint8_t>> ser_pay(n_shards), ser_ppay(n_shards);
    std::vector<std::vector<uint32_t>> ser_bank(n_shards);
    for (int t = 0; t < n_shards; ++t) {
      const Shard& sh = shards[t];
      model_t[t].resize(kCols * sh.n);
      qs_t[t].resize(kCols * sh.n);
      std::vector<uint8_t> recon(kCols * sh.n);
      double d = 0;
      qvz_quantize_colmajor(enc_tb, sh.data_t.data(), sh.n, sh.cl.data(),
                            sh.state, dist.data(), recon.data(), &d,
                            model_t[t].data(), qs_t[t].data());
      CHECK(recon == fused_recon[t]);
      CHECK(d == fused_d[t]);
      std::vector<uint8_t> pay(payload_cap(sh.n));
      ser_bank[t].resize(bank_words);
      int64_t r = qvz_encode_precomputed_colmajor(
          enc_tb, model_t[t].data(), qs_t[t].data(), sh.cl.data(), sh.n,
          pay.data(), pay.size(), nullptr, ser_bank[t].data());
      CHECK(r > 0);
      ser_pay[t].assign(pay.begin(), pay.begin() + r);
      CHECK(ser_pay[t] == fused_pay[t]);
      if (t == 0) {
        CHECK(ser_bank[0] == warm_bank);
        continue;
      }
      r = qvz_encode_precomputed_colmajor(
          enc_tb, model_t[t].data(), qs_t[t].data(), sh.cl.data(), sh.n,
          pay.data(), pay.size(), warm_bank.data(), nullptr);
      CHECK(r > 0);
      ser_ppay[t].assign(pay.begin(), pay.begin() + r);
      CHECK(ser_ppay[t] == primed_pay[t]);
    }
    for (void* tb : {dec_tb, enc_tb}) {
      run_threads(n_shards, [&](int t) {
        const Shard& sh = shards[t];
        std::vector<uint8_t> pay(payload_cap(sh.n));
        std::vector<uint32_t> bank(bank_words), sbank(bank_words);
        int64_t r = qvz_encode_precomputed_colmajor(
            tb, model_t[t].data(), qs_t[t].data(), sh.cl.data(), sh.n,
            pay.data(), pay.size(), nullptr, bank.data());
        CHECK(r > 0);
        CHECK(std::vector<uint8_t>(pay.begin(), pay.begin() + r) ==
              ser_pay[t]);
        CHECK(bank == ser_bank[t]);
        qvz_bank_from_stream(tb, model_t[t].data(), qs_t[t].data(),
                             sh.cl.data(), sh.n, sbank.data());
        CHECK(sbank == ser_bank[t]);
        if (t == 0) return;
        r = qvz_encode_precomputed_colmajor(
            tb, model_t[t].data(), qs_t[t].data(), sh.cl.data(), sh.n,
            pay.data(), pay.size(), warm_bank.data(), bank.data());
        CHECK(r > 0);
        CHECK(std::vector<uint8_t>(pay.begin(), pay.begin() + r) ==
              ser_ppay[t]);
        std::vector<uint8_t> out(sh.n * (kCols + 1));
        std::vector<uint32_t> dbank(bank_words);
        CHECK(qvz_decode_colmajor(dec_tb, pay.data(), r, sh.n, sh.state,
                                  out.data(), warm_bank.data(), dbank.data(),
                                  nullptr, nullptr) == 0);
        CHECK(dbank == bank);
      });
    }
    std::printf("quantize + precomputed encode (bank out/in) + "
                "bank_from_stream x%d threads, both tables: ok\n",
                n_shards);
  }

  // 8. The v1 (line-major) stream from the precomputed decisions, one
  //    thread a shard: equal to the fused line-major encode, decoded back.
  std::vector<std::vector<uint8_t>> v1_pay(n_shards);
  run_threads(n_shards, [&](int t) {
    const Shard& sh = shards[t];
    const uint64_t n = sh.n;
    std::vector<uint32_t> mid(n * kCols);
    std::vector<uint8_t> sym(n * kCols), rows(n * kCols), recon(n * kCols);
    for (uint64_t i = 0; i < n; ++i)
      for (uint32_t c = 0; c < kCols; ++c) {
        mid[i * kCols + c] = model_t[t][c * n + i];
        sym[i * kCols + c] = qs_t[t][c * n + i];
        rows[i * kCols + c] = sh.data_t[c * n + i];
      }
    std::vector<uint8_t> pay(payload_cap(n)), fpay(payload_cap(n));
    const int64_t r = qvz_encode_lines(sh.cl.data(), mid.data(), sym.data(),
                                       n, kCols, qvz_tables_model_card(enc_tb),
                                       qvz_tables_n_models(enc_tb), pay.data(),
                                       pay.size());
    CHECK(r > 0);
    double d = 0;
    const int64_t fr = qvz_encode_fused(enc_tb, rows.data(), n, sh.cl.data(),
                                        sh.state, dist.data(), recon.data(),
                                        &d, fpay.data(), fpay.size(), 0);
    CHECK(fr == r);
    CHECK(std::memcmp(pay.data(), fpay.data(), r) == 0);
    pay.resize(r);
    v1_pay[t] = pay;
    std::vector<uint8_t> out(n * (kCols + 1)), cl_out(n);
    CHECK(qvz_decode_lines(dec_tb, pay.data(), r, n, sh.state, out.data(),
                           cl_out.data(), 0) == 0);
    CHECK(cl_out == sh.cl);
    for (uint64_t i = 0; i < n; ++i)
      for (uint32_t c = 0; c < kCols; ++c)
        CHECK(out[i * (kCols + 1) + c] == recon[i * kCols + c] + 33);
  });
  std::printf("encode_lines + decode_lines x%d threads: ok\n", n_shards);

  // 9. replay_model over streams long enough to rescale (a total past
  //    2^19 after 65,536 updates), from concurrent threads.
  {
    const int nt = 4;
    const uint32_t card = 5;
    const uint64_t len = 70000;
    std::vector<uint8_t> syms(len * nt);
    for (auto& x : syms) x = static_cast<uint8_t>(rnd() % card);
    const std::vector<uint32_t> init = {1, 3, 2, 7, 1};
    const uint32_t init_total = 14;
    std::vector<std::vector<uint32_t>> outs(nt);
    run_threads(nt, [&](int t) {
      outs[t].resize(len * 3);
      qvz_replay_model(init.data(), card, init_total,
                       syms.data() + t * len, len, outs[t].data());
    });
    for (int t = 0; t < nt; ++t) {
      std::vector<uint32_t> ref(len * 3);
      qvz_replay_model(init.data(), card, init_total, syms.data() + t * len,
                       len, ref.data());
      CHECK(ref == outs[t]);
      bool rescaled = false;
      for (uint64_t i = 1; i < len; ++i)
        rescaled |= ref[i * 3 + 2] < ref[(i - 1) * 3 + 2];
      CHECK(rescaled);
    }
    std::printf("replay_model x%d concurrent (with rescales): ok\n", nt);
  }

  // 10. Corrupt payloads, one thread a shard: cuts and bit flips, each in
  //     an exact-size heap buffer. Any status is one of the decoders'
  //     codes; a payload cut to half or less must fail.
  {
    std::vector<int> failures(n_shards, 0);
    run_threads(n_shards, [&](int t) {
      const Shard& sh = shards[t];
      const uint64_t n = sh.n;
      uint64_t x = 0x2545F4914F6CDD1Dull + t;
      auto next = [&]() {
        x ^= x << 13;
        x ^= x >> 7;
        x ^= x << 17;
        return x;
      };
      std::vector<uint8_t> out(n * (kCols + 1)), cl_out(n);
      uint64_t pst[4];
      for (const auto* src : {&fused_pay[t], &v1_pay[t]}) {
        const bool colmajor = src == &fused_pay[t];
        const uint64_t len = src->size();
        std::vector<std::vector<uint8_t>> cases;
        for (uint64_t cut : {uint64_t{0}, uint64_t{1}, uint64_t{7}, len / 4,
                             len / 2, len - 1})
          cases.emplace_back(src->begin(), src->begin() + cut);
        for (int f = 0; f < 12; ++f) {
          std::vector<uint8_t> bad = *src;
          bad[next() % len] ^= static_cast<uint8_t>(1u << (next() % 8));
          cases.push_back(bad);
        }
        for (size_t k = 0; k < cases.size(); ++k) {
          const uint64_t blen = cases[k].size();
          auto buf = exact_copy(cases[k].data(), blen);
          int32_t rc;
          if (colmajor) {
            rc = qvz_decode_colmajor(dec_tb, buf.get(), blen, n, sh.state,
                                     out.data(), nullptr, nullptr,
                                     cl_out.data(), nullptr);
            const int32_t pr = qvz_decode_cluster_prologue(
                dec_tb, buf.get(), blen, n, nullptr, cl_out.data(), pst);
            CHECK(decode_status_ok(pr));
          } else {
            rc = qvz_decode_lines(dec_tb, buf.get(), blen, n, sh.state,
                                  out.data(), cl_out.data(), 0);
          }
          CHECK(decode_status_ok(rc));
          if (k < 6 && blen <= len / 2) CHECK(rc != 0);
          failures[t] += rc != 0;
        }
      }
    });
    int total = 0;
    for (int f : failures) total += f;
    std::printf("corrupt payload decodes x%d threads: ok (%d refused)\n",
                n_shards, total);
  }

  qvz_tables_free(dec_tb);
  qvz_tables_free(enc_tb);
  qvz_design_free(design);
  std::printf("sanitize harness: ALL OK\n");
  return 0;
}
