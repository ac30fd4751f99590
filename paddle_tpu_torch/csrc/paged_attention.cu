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
// Bound and design: split_decode.cuh (bytes-bound; one launch of
// stretches planned on the host, a cp.async ring, tensor cores for bf16
// queries, the splits merged by the last CTA of each sequence and head).
// An int8 row is half a bf16 row's bytes (plus 4 bytes of scale per K or
// V row in the per-row mode). The address policy below maps a token to its
// pool row through the block table. Only table entries below
// ceil(len / block_size) are read: the engine leaves later entries
// arbitrary, and a stale id may lie outside the pool (such a row is
// skipped, never dereferenced).
#include <climits>

#include "split_decode.cuh"

using namespace ptt;
namespace sd = ptt::split_decode;

namespace {

template <int Scale>
struct PagedRows {
  static constexpr int kScale = Scale;
  const int* tables;  // (B, w)
  const int* lens;    // (B,)
  // dequant scales: (HK,) for kHeadScale, (num_blocks, block_size, HK)
  // for kRowScale (row-major: a pool row's index times HK plus the
  // head's); unused for kNoScale
  const float* k_scale;
  const float* v_scale;
  int num_blocks, bs, w;

  __device__ int length(int b) const { return min(lens[b], w * bs); }

  __device__ int row(int b, int pos) const {
    const int blk = tables[static_cast<size_t>(b) * w + pos / bs];
    if (blk < 0 || blk >= num_blocks) return -1;
    return blk * bs + pos % bs;
  }
};

// False for a pool, table or plan the kernel refuses.
bool checked(const sd::Launch& a, int num_blocks, int block_size,
             int table_width) {
  return block_size > 0 && table_width > 0 && num_blocks >= 0 &&
         static_cast<long long>(num_blocks) * block_size <= INT_MAX &&
         sd::valid(a, static_cast<long long>(table_width) * block_size);
}

}  // namespace

// The plan's limits (ops/split_decode.py checks them when it loads the
// library): 0 the stretch unit, 1 the longest stretch, 2 the most splits.
extern "C" int ptt_decode_split_limit(int which) {
  return which == 0 ? sd::kStretchUnit
                    : (which == 1 ? sd::kMaxStretch : sd::kMaxSplits);
}

// part_o: (B, HK, nsplit, G, D) f32 and part_ml: (B, HK, nsplit, G, 2)
// f32 scratch (unused when nsplit is 1); tickets: B * HK int32, zero
// (each launch leaves them zero). stretch, nsplit: the plan
// (ops/split_decode.py), nsplit * stretch >= table_width * block_size.
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lens, void* out, void* part_o,
    void* part_ml, void* tickets, int b, int h, int hk, int d,
    int num_blocks, int block_size, int table_width, int stretch,
    int nsplit, float sm_scale, int dtype, void* stream) {
  if (b <= 0) return 0;
  const sd::Launch a{q, k_pool, v_pool, out, static_cast<float*>(part_o),
                     static_cast<float*>(part_ml),
                     static_cast<int*>(tickets), b, h, hk, stretch, nsplit,
                     sm_scale, static_cast<cudaStream_t>(stream)};
  if (!checked(a, num_blocks, block_size, table_width))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows<sd::kNoScale> rows{
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      nullptr, nullptr, num_blocks, block_size, table_width};
  return sd::dispatch(a, rows, d, dtype);
}

// The int8 arm: int8 pools, q and out f32 or bf16 (dtype). per_row = 0:
// k_scale / v_scale are (HK,) f32 (the TPU kernel's static arm); 1: they
// are (num_blocks, block_size, HK) f32 scale pools, one per pool row.
extern "C" int ptt_paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lens, void* out, void* part_o, void* part_ml, void* tickets,
    int b, int h, int hk, int d, int num_blocks, int block_size,
    int table_width, int stretch, int nsplit, float sm_scale, int dtype,
    int per_row, void* stream) {
  if (b <= 0) return 0;
  const sd::Launch a{q, k_pool, v_pool, out, static_cast<float*>(part_o),
                     static_cast<float*>(part_ml),
                     static_cast<int*>(tickets), b, h, hk, stretch, nsplit,
                     sm_scale, static_cast<cudaStream_t>(stream)};
  if (!checked(a, num_blocks, block_size, table_width))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tbl = static_cast<const int*>(tables);
  const auto* ln = static_cast<const int*>(lens);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  if (per_row) {
    const PagedRows<sd::kRowScale> rows{tbl, ln, ks, vs, num_blocks,
                                        block_size, table_width};
    return sd::dispatch<true>(a, rows, d, dtype);
  }
  const PagedRows<sd::kHeadScale> rows{tbl, ln, ks, vs, num_blocks,
                                       block_size, table_width};
  return sd::dispatch<true>(a, rows, d, dtype);
}

// The static-scale arm over float pools of q's dtype (dtype): the TPU
// kernel applies (HK,) scales to any pool. The same address mode as the
// int8 arm's static scales, with the cache element of the float instances.
extern "C" int ptt_paged_decode_attention_scaled(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lens, void* out, void* part_o, void* part_ml, void* tickets,
    int b, int h, int hk, int d, int num_blocks, int block_size,
    int table_width, int stretch, int nsplit, float sm_scale, int dtype,
    void* stream) {
  if (b <= 0) return 0;
  const sd::Launch a{q, k_pool, v_pool, out, static_cast<float*>(part_o),
                     static_cast<float*>(part_ml),
                     static_cast<int*>(tickets), b, h, hk, stretch, nsplit,
                     sm_scale, static_cast<cudaStream_t>(stream)};
  if (!checked(a, num_blocks, block_size, table_width))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows<sd::kHeadScale> rows{
      static_cast<const int*>(tables), static_cast<const int*>(lens),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      num_blocks, block_size, table_width};
  return sd::dispatch(a, rows, d, dtype);
}
