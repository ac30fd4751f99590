// Paged-KV decode attention (K2) for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py,
// `paged_decode_attention` -> `_paged_kernel` (one query token per
// sequence attends its cached context through a per-sequence block table
// into a shared (num_blocks, block_size, HK, D) pool; the GQA group of
// query heads forms the rows of the score product; online f32 softmax).
//
// Bound and design: split_decode.cuh (bytes-bound; grid B x HK x splits of
// 128 tokens, one warp per token stream, a second pass merges the splits).
// The address policy below maps a token to its pool row through the block
// table. Only table entries below ceil(len / block_size) are read: the
// engine leaves later entries arbitrary, and a stale id may lie outside the
// pool (such a row is skipped, never dereferenced).
#include "split_decode.cuh"

using namespace ptt;

namespace {

struct PagedRows {
  const int* tables;  // (B, w)
  const int* lens;    // (B,)
  int num_blocks, bs, w, hk, d;

  __device__ int length(int b) const { return min(lens[b], w * bs); }

  __device__ bool row(int b, int pos, int kvh, size_t* off) const {
    const int blk = tables[static_cast<size_t>(b) * w + pos / bs];
    if (blk < 0 || blk >= num_blocks) return false;
    *off = ((static_cast<size_t>(blk) * bs + pos % bs) * hk + kvh) * d;
    return true;
  }
};

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
  if (hk <= 0 || h % hk != 0 || h / hk > split_decode::kMaxGroup ||
      block_size <= 0 || table_width <= 0 ||
      nsplit * split_decode::kSplitTokens < table_width * block_size ||
      !aligned16(q) || !aligned16(k_pool) || !aligned16(v_pool))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(tables),
                       static_cast<const int*>(lens), num_blocks, block_size,
                       table_width, hk, d};
  return split_decode::dispatch(
      q, k_pool, v_pool, rows, out, static_cast<float*>(part_o),
      static_cast<float*>(part_ml), b, h, hk, d, nsplit, sm_scale, dtype,
      static_cast<cudaStream_t>(stream));
}
