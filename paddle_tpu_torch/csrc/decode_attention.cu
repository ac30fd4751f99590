// Contiguous-cache decode attention (K5) for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py, `decode_attention`
// -> `_decode_kernel` (one query token per sequence attends a contiguous
// (B, S_max, HK, D) cache up to its length seq_lens[b]; the GQA group of
// query heads forms the rows of the score product; q, k and v upcast to
// f32, online f32 softmax, P not rounded; output in q's dtype, 1e-30 clamp
// on the row sum).
//
// Bound and design: split_decode.cuh (bytes-bound; one launch of
// stretches planned on the host, a cp.async ring, tensor cores for bf16
// queries, the splits merged by the last CTA of each sequence and head).
// At the generate shapes (B=4, HK=8, 4,096 cached tokens) the plan gives
// 32 stretches of 128 tokens per (row, KV head), 1,024 CTAs instead of the
// 32 a CTA per (row, KV head) would give. The TPU kernel pads S up to its
// key block and masks k_pos < length; here no row at or past
// min(seq_lens[b], S_max) is ever read, because a read past S_max would
// be an illegal address on the card.
#include <climits>

#include "split_decode.cuh"

using namespace ptt;
namespace sd = ptt::split_decode;

namespace {

struct ContiguousRows {
  static constexpr int kScale = sd::kNoScale;
  const int* lens;  // (B,)
  int s_max;
  const float* k_scale;  // unused
  const float* v_scale;

  __device__ int length(int b) const { return min(lens[b], s_max); }

  __device__ int row(int b, int pos) const { return b * s_max + pos; }
};

}  // namespace

// part_o: (B, HK, nsplit, G, D) f32 and part_ml: (B, HK, nsplit, G, 2)
// f32 scratch (unused when nsplit is 1); tickets: B * HK int32, zero
// (each launch leaves them zero). stretch, nsplit: the plan
// (ops/split_decode.py), nsplit * stretch >= s_max.
extern "C" int ptt_decode_attention(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lens,
                                    void* out, void* part_o, void* part_ml,
                                    void* tickets, int b, int h, int hk,
                                    int d, int s_max, int stretch,
                                    int nsplit, float sm_scale, int dtype,
                                    void* stream) {
  if (b <= 0) return 0;
  const sd::Launch a{q, k_cache, v_cache, out, static_cast<float*>(part_o),
                     static_cast<float*>(part_ml),
                     static_cast<int*>(tickets), b, h, hk, stretch, nsplit,
                     sm_scale, static_cast<cudaStream_t>(stream)};
  if (s_max <= 0 || static_cast<long long>(b) * s_max > INT_MAX ||
      !sd::valid(a, s_max))
    return static_cast<int>(cudaErrorInvalidValue);
  const ContiguousRows rows{static_cast<const int*>(lens), s_max, nullptr,
                            nullptr};
  return sd::dispatch(a, rows, d, dtype);
}
