// Paged-KV decode attention (K2) for Hopper, float pools and the int8 arm.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py,
// `paged_decode_attention` -> `_paged_kernel` (one query token per
// sequence attends its cached context through a per-sequence block table
// into a shared (num_blocks, block_size, HK, D) pool; the GQA group of
// query heads forms the rows of the score product; online f32 softmax).
// Its `has_scales` arm (`_paged_kernel` lines 53-58) multiplies the rows
// of any pool by static per-KV-head (HK,) f32 scales: int8 pools (the
// int8 arm) and float pools (the scaled mode below); the same kernel also
// takes (num_blocks, block_size, HK) per-row f32 scale pools over int8,
// the int8 serving engine's pools, for which the reference has only an
// XLA gather (`_xla_paged_decode_attn(ks=, vs=)` in serving/engine.py).
//
// Bound and design: split_decode.cuh (bytes-bound; grid B x HK x splits of
// 128 tokens, one warp per token stream, a second pass merges the splits).
// An int8 row is half a bf16 row's bytes (plus 4 bytes of scale per K or
// V row in the per-row mode). The address policy below maps a token to its
// pool row through the block table. Only table entries below
// ceil(len / block_size) are read: the engine leaves later entries
// arbitrary, and a stale id may lie outside the pool (such a row is
// skipped, never dereferenced).
#include "split_decode.cuh"

using namespace ptt;

namespace {

template <int Scale>
struct PagedRows {
  static constexpr int kScale = Scale;
  const int* tables;  // (B, w)
  const int* lens;    // (B,)
  // dequant scales: (HK,) for kHeadScale, (num_blocks, block_size, HK)
  // for kRowScale (row-major: a pool row's index); unused for kNoScale
  const float* k_scale;
  const float* v_scale;
  int num_blocks, bs, w, hk, d;

  __device__ int length(int b) const { return min(lens[b], w * bs); }

  __device__ bool row(int b, int pos, int kvh, size_t* off) const {
    const int blk = tables[static_cast<size_t>(b) * w + pos / bs];
    if (blk < 0 || blk >= num_blocks) return false;
    *off = ((static_cast<size_t>(blk) * bs + pos % bs) * hk + kvh) * d;
    return true;
  }

  __device__ float2 scales(int kvh, size_t row) const {
    const size_t i = Scale == split_decode::kHeadScale ? kvh : row;
    return make_float2(k_scale[i], v_scale[i]);
  }
};

bool valid(const void* q, const void* k_pool, const void* v_pool, int h,
           int hk, int block_size, int table_width, int nsplit) {
  return hk > 0 && h % hk == 0 && h / hk <= split_decode::kMaxGroup &&
         block_size > 0 && table_width > 0 &&
         nsplit * split_decode::kSplitTokens >= table_width * block_size &&
         aligned16(q) && aligned16(k_pool) && aligned16(v_pool);
}

}  // namespace

extern "C" int ptt_paged_split_tokens() { return split_decode::kSplitTokens; }

// part_o: (B, HK, nsplit, G, D) f32 and part_ml: (B, HK, nsplit, G, 2)
// f32 scratch, nsplit >= ceil(table_width * block_size / split tokens).
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lens, void* out, void* part_o,
    void* part_ml, int b, int h, int hk, int d, int num_blocks,
    int block_size, int table_width, int nsplit, float sm_scale, int dtype,
    void* stream) {
  if (b <= 0) return 0;
  if (!valid(q, k_pool, v_pool, h, hk, block_size, table_width, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows<split_decode::kNoScale> rows{
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      nullptr, nullptr, num_blocks, block_size, table_width, hk, d};
  return split_decode::dispatch(
      q, k_pool, v_pool, rows, out, static_cast<float*>(part_o),
      static_cast<float*>(part_ml), b, h, hk, d, nsplit, sm_scale, dtype,
      static_cast<cudaStream_t>(stream));
}

// The int8 arm: int8 pools, q and out f32 or bf16 (dtype). per_row = 0:
// k_scale / v_scale are (HK,) f32 (the TPU kernel's static arm); 1: they
// are (num_blocks, block_size, HK) f32 scale pools, one per pool row.
extern "C" int ptt_paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lens, void* out, void* part_o, void* part_ml, int b, int h,
    int hk, int d, int num_blocks, int block_size, int table_width,
    int nsplit, float sm_scale, int dtype, int per_row, void* stream) {
  if (b <= 0) return 0;
  if (!valid(q, k_pool, v_pool, h, hk, block_size, table_width, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tbl = static_cast<const int*>(tables);
  const auto* ln = static_cast<const int*>(lens);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  auto* po = static_cast<float*>(part_o);
  auto* pml = static_cast<float*>(part_ml);
  auto* st = static_cast<cudaStream_t>(stream);
  if (per_row) {
    const PagedRows<split_decode::kRowScale> rows{
        tbl, ln, ks, vs, num_blocks, block_size, table_width, hk, d};
    return split_decode::dispatch<true>(q, k_pool, v_pool, rows, out, po,
                                        pml, b, h, hk, d, nsplit, sm_scale,
                                        dtype, st);
  }
  const PagedRows<split_decode::kHeadScale> rows{
      tbl, ln, ks, vs, num_blocks, block_size, table_width, hk, d};
  return split_decode::dispatch<true>(q, k_pool, v_pool, rows, out, po, pml,
                                      b, h, hk, d, nsplit, sm_scale, dtype,
                                      st);
}

// The static-scale arm over float pools of q's dtype (dtype): the TPU
// kernel applies (HK,) scales to any pool. The same address mode as the
// int8 arm's static scales, with the cache element of the float instances.
extern "C" int ptt_paged_decode_attention_scaled(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lens, void* out, void* part_o, void* part_ml, int b, int h,
    int hk, int d, int num_blocks, int block_size, int table_width,
    int nsplit, float sm_scale, int dtype, void* stream) {
  if (b <= 0) return 0;
  if (!valid(q, k_pool, v_pool, h, hk, block_size, table_width, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows<split_decode::kHeadScale> rows{
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      num_blocks, block_size, table_width, hk, d};
  return split_decode::dispatch(
      q, k_pool, v_pool, rows, out, static_cast<float*>(part_o),
      static_cast<float*>(part_ml), b, h, hk, d, nsplit, sm_scale, dtype,
      static_cast<cudaStream_t>(stream));
}
