// Public C API of the native runtime (qvz_rt.cpp).
//
// Included by qvz_rt.cpp, so a signature drift is a compile error
// instead of a garbage-argument crash at runtime. Python binds these via
// ctypes (native/__init__.py); keep the three places in sync — the
// header is the source of truth.
#pragma once

#include <cstdint>

extern "C" {

// --- WELL-1024a -----------------------------------------------------------
void qvz_well_draws7(const uint32_t* state, uint64_t n_draws, uint8_t* out);
void qvz_well_jump(const uint32_t* state, uint32_t n_chunks,
                   uint64_t words_per_chunk, uint32_t* out);
void qvz_well_pow_table(uint64_t* out);

// --- integrity ------------------------------------------------------------
uint64_t qvz_xxh64(const uint8_t* p, uint64_t len, uint64_t seed);

// --- codebook design ------------------------------------------------------
void* qvz_design_create(const uint64_t* counts0, const uint64_t* cond_counts,
                        uint32_t n_clusters, uint32_t columns, int32_t mode,
                        double ratio, const double* dist);
int64_t qvz_design_serialized_size(void* h);
void qvz_design_serialized(void* h, uint8_t* out);
// out[3]: the design's nanoseconds outside the context sweeps (summed
// over clusters), its Lloyd-Max iterations, and those of speculative
// candidates it discarded.
void qvz_design_stats(void* h, int64_t* out);
void qvz_design_free(void* h);

// --- coding tables --------------------------------------------------------
void* qvz_tables_from_design(void* design_handle);
void* qvz_tables_from_blocks(const uint8_t* blocks, int64_t len,
                             uint32_t n_clusters, uint32_t columns);
void qvz_tables_free(void* h);
uint64_t qvz_tables_n_pairs(void* h);
uint32_t qvz_tables_n_models(void* h);
int64_t qvz_tables_consumed(void* h);
uint64_t qvz_tables_model_syms_len(void* h);
uint64_t qvz_tables_bank_words(void* h);
const uint32_t* qvz_tables_pair_base(void* h);
const int32_t* qvz_tables_ctxmap(void* h);
const uint8_t* qvz_tables_qratio(void* h);
const uint32_t* qvz_tables_model_card(void* h);
const uint64_t* qvz_tables_model_off(void* h);
const uint8_t* qvz_tables_model_syms(void* h);
const uint8_t* qvz_tables_qv_map(void* h);
const uint8_t* qvz_tables_qs_map(void* h);
const uint32_t* qvz_tables_ctx2(void* h);
const uint16_t* qvz_tables_qsv(void* h);

// --- batch passes ---------------------------------------------------------
void qvz_stats(const uint8_t* data, uint64_t n_lines, uint32_t columns,
               const uint8_t* cluster_ids, uint64_t* counts0,
               uint64_t* cond);
void qvz_kmeans_iter(const uint8_t* data, uint64_t n_lines, uint32_t cols,
                     const int64_t* means, uint32_t k, uint8_t* assign,
                     int64_t* sums, int64_t* counts);
void qvz_quantize_colmajor(void* tables, const uint8_t* data_t,
                           uint64_t n_lines, const uint8_t* cluster_ids,
                           const uint32_t* well_state, const double* dist,
                           uint8_t* recon_t, double* distortion_out,
                           uint32_t* model_t, uint8_t* qs_t);

// --- coding ---------------------------------------------------------------
int64_t qvz_encode_lines(const uint8_t* cluster_ids,
                         const uint32_t* model_ids, const uint8_t* syms,
                         uint64_t n_lines, uint32_t columns,
                         const uint32_t* model_cards, uint32_t n_models,
                         uint8_t* out, int64_t cap);
int64_t qvz_encode_fused(void* tables, const uint8_t* data, uint64_t n_lines,
                         const uint8_t* cluster_ids,
                         const uint32_t* well_state, const double* dist,
                         uint8_t* recon, double* distortion_out,
                         uint8_t* out, int64_t cap, int32_t verbose);
int64_t qvz_encode_fused_colmajor(void* tables, const uint8_t* data_t,
                                  uint64_t n_lines,
                                  const uint8_t* cluster_ids,
                                  const uint32_t* well_state,
                                  const double* dist, uint8_t* recon_t,
                                  double* distortion_out, uint8_t* out,
                                  int64_t cap, const uint32_t* init_bank,
                                  uint32_t* out_bank);
int64_t qvz_encode_precomputed_colmajor(void* tables,
                                        const uint32_t* model_t,
                                        const uint8_t* qs_t,
                                        const uint8_t* cluster_ids,
                                        uint64_t n_lines, uint8_t* out,
                                        int64_t cap,
                                        const uint32_t* init_bank,
                                        uint32_t* out_bank);
int32_t qvz_decode_lines(void* tables, const uint8_t* payload,
                         uint64_t payload_len, uint64_t n_lines,
                         const uint32_t* well_state, uint8_t* out,
                         uint8_t* cluster_out, int32_t verbose);
int32_t qvz_decode_colmajor(void* tables, const uint8_t* payload,
                            uint64_t payload_len, uint64_t n_lines,
                            const uint32_t* well_state, uint8_t* out,
                            const uint32_t* init_bank, uint32_t* out_bank,
                            uint8_t* cluster_out,
                            const uint8_t* draws_t_in);

// Cluster-segment prologue: decodes the per-shard cluster ids (model 0)
// and exports the coder state where the lane decoder resumes: state_out
// = {l, u, t, consumed bits}. The host oracle of the device's K5p.
int32_t qvz_decode_cluster_prologue(void* tables, const uint8_t* payload,
                                    uint64_t payload_len, uint64_t n_lines,
                                    const uint32_t* init_bank,
                                    uint8_t* cluster_out,
                                    uint64_t* state_out);

// Model-bank snapshot after replaying a precomputed (model, symbol)
// stream without coding it (bank updates are interval-independent).
// Lets the warmup shard's payload coding overlap the device lanes.
void qvz_bank_from_stream(void* tables, const uint32_t* model_t,
                          const uint8_t* qs_t, const uint8_t* cluster_ids,
                          uint64_t n_lines, uint32_t* out_bank);

// Exact adaptive-model replay for ONE model: per-occurrence
// (cum_lo, cum_hi, total) triples with the full update semantics
// (counts += 8, halve+1 rescale past r — qv_stream.c:9-25). The host
// oracle of the device coder's K2s, the cluster-id segment's triples.
void qvz_replay_model(const uint32_t* init_counts, uint32_t card,
                      uint32_t init_total, const uint8_t* syms,
                      uint64_t n, uint32_t* out_triples);

}  // extern "C"
