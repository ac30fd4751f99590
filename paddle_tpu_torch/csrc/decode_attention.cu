// Contiguous-cache decode attention (K5) for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py, `decode_attention`
// -> `_decode_kernel` (one query token per sequence attends a contiguous
// (B, S_max, HK, D) cache up to its length seq_lens[b]; the GQA group of
// query heads forms the rows of the score product; q, k and v upcast to
// f32, online f32 softmax, P not rounded; output in q's dtype, 1e-30 clamp
// on the row sum).
//
// Bound and design: split_decode.cuh (bytes-bound; grid B x HK x splits of
// 128 tokens, one warp per token stream, a second pass merges the splits).
// At the generate shapes (B=4, HK=8, 4,096 cached tokens) that is 1,024
// CTAs of work instead of the 32 a CTA per (row, KV head) would give. The
// TPU kernel pads S up to its key block and masks k_pos < length; here no
// row at or past min(seq_lens[b], S_max) is ever read, because a read past
// S_max would be an illegal address on the card.
#include "split_decode.cuh"

using namespace ptt;

namespace {

struct ContiguousRows {
  static constexpr int kScale = split_decode::kNoScale;
  const int* lens;  // (B,)
  int s_max, hk, d;

  __device__ int length(int b) const { return min(lens[b], s_max); }

  __device__ bool row(int b, int pos, int kvh, size_t* off) const {
    *off = ((static_cast<size_t>(b) * s_max + pos) * hk + kvh) * d;
    return true;
  }
};

}  // namespace

// part_o: (B, HK, nsplit, G, D) f32 and part_ml: (B, HK, nsplit, G, 2)
// f32 scratch, nsplit >= ceil(s_max / split tokens).
extern "C" int ptt_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lens,
                                    void* out, void* part_o, void* part_ml,
                                    int b, int h, int hk, int d, int s_max,
                                    int nsplit, float sm_scale, int dtype,
                                    void* stream) {
  if (b <= 0) return 0;
  if (hk <= 0 || h % hk != 0 || h / hk > split_decode::kMaxGroup ||
      s_max <= 0 || nsplit * split_decode::kSplitTokens < s_max ||
      !aligned16(q) || !aligned16(k_cache) || !aligned16(v_cache))
    return static_cast<int>(cudaErrorInvalidValue);
  const ContiguousRows rows{static_cast<const int*>(lens), s_max, hk, d};
  return split_decode::dispatch(
      q, k_cache, v_cache, rows, out, static_cast<float*>(part_o),
      static_cast<float*>(part_ml), b, h, hk, d, nsplit, sm_scale, dtype,
      static_cast<cudaStream_t>(stream));
}
