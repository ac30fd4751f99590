// Paged-KV decode attention (K2) for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py,
// `paged_decode_attention` -> `_paged_kernel` (one query token per
// sequence attends its cached context through a per-sequence block table
// into a shared (num_blocks, block_size, HK, D) pool; the GQA group of
// query heads forms the rows of the score product; online f32 softmax).
//
// Bound on the H100: bytes. Every live K/V row is read once and used for
// 2 * G * D multiply-adds (G = query heads per KV head, 1..8), a few
// flops per byte, far below the ~295 flop/byte ridge. The floor is the
// live K/V bytes over 3.35 TB/s.
//
// Design (split over the sequence, "flash decoding"): grid (B, HK,
// splits), each split a 256-token stretch of one sequence, so a long
// sequence spreads over many SMs instead of being walked by one CTA.
// Inside a CTA each of the 4 warps streams its own tokens with no block
// barrier: a lane holds D/32 dims of the G queries in registers, loads
// the matching D/32 dims of 4 K and 4 V rows at once (several loads in
// flight per lane), reduces q.k with shuffles and keeps its own running
// max m, sum l and accumulator in f32 registers. The warps then merge
// through shared memory and each split writes (m, l, acc) to a small f32
// scratch; a second kernel merges the splits, rescaling by exp(m_s - m).
// Only table entries below ceil(len / block_size) are read: the engine
// leaves later entries arbitrary, and a stale id may lie outside the pool.
#include "common.cuh"

using namespace ptt;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;   // query heads per KV head
constexpr int kUnroll = 4;     // K/V rows each warp loads at once
constexpr int kSplitTokens = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_pack(const T* p, float* out) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(pk.v[i]);
}

// One split: part_o[b, kvh, split] (G, D) unnormalised accumulator and
// part_ml[b, kvh, split] (G, 2) = (running max, running sum).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens,
                       float* __restrict__ part_o,
                       float* __restrict__ part_ml, int h, int hk,
                       int num_blocks, int bs, int w, int nsplit,
                       float sm_scale) {
  constexpr int D = DPL * 32;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int group = h / hk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = min(lens[b], w * bs);
  const int t0 = split * kSplitTokens;
  if (t0 >= len) return;  // the merge reads only splits below len
  const int t1 = min(t0 + kSplitTokens, len);

  float qr[kMaxGroup][DPL];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
    if (g < group) {
      load_pack<T, DPL>(
          q + (static_cast<size_t>(b) * h + kvh * group + g) * D + lane * DPL,
          qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) qr[g][i] = 0.f;
    }
  }

  const int* trow = tables + static_cast<size_t>(b) * w;
  for (int base = t0 + warp * kUnroll; base < t1;
       base += kWarps * kUnroll) {
    float kf[kUnroll][DPL], vf[kUnroll][DPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u;
      ok[u] = pos < t1;
      if (ok[u]) {
        const int blk = trow[pos / bs];
        ok[u] = blk >= 0 && blk < num_blocks;
        if (ok[u]) {
          const size_t off =
              ((static_cast<size_t>(blk) * bs + pos % bs) * hk + kvh) * D +
              lane * DPL;
          load_pack<T, DPL>(kp + off, kf[u]);
          load_pack<T, DPL>(vp + off, vf[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;  // uniform over the warp: same pos, same blk
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= group) break;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) s = fmaf(qr[g][i], kf[u][i], s);
        s = warp_sum(s) * sm_scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = alpha * l[g] + p;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[g][i] = fmaf(p, vf[u][i], acc[g][i] * alpha);
        m[g] = m_new;
      }
    }
  }

  // merge the warps of this CTA
  __shared__ float w_ml[kWarps][kMaxGroup][2];
  __shared__ float w_acc[kWarps][kMaxGroup][D];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      if (lane == 0) {
        w_ml[warp][g][0] = m[g];
        w_ml[warp][g][1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) w_acc[warp][g][lane * DPL + i] = acc[g][i];
    }
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * hk + kvh) * nsplit + split;
  for (int e = threadIdx.x; e < group * D; e += kThreads) {
    const int g = e / D;
    const int c = e - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) mx = fmaxf(mx, w_ml[k][g][0]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float f = expf(w_ml[k][g][0] - mx);
      a = fmaf(w_acc[k][g][c], f, a);
      sum = fmaf(w_ml[k][g][1], f, sum);
    }
    part_o[part * group * D + e] = a;
    if (c == 0) {
      part_ml[(part * group + g) * 2] = mx;
      part_ml[(part * group + g) * 2 + 1] = sum;
    }
  }
}

// Merge the live splits of each (sequence, KV head) into the output.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_merge_kernel(const float* __restrict__ part_o,
                       const float* __restrict__ part_ml,
                       const int* __restrict__ lens, T* __restrict__ out,
                       int h, int hk, int d, int bs, int w, int nsplit) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = h / hk;
  const int len = min(lens[b], w * bs);
  const int live = len > 0 ? (len + kSplitTokens - 1) / kSplitTokens : 0;
  const size_t part0 = (static_cast<size_t>(b) * hk + kvh) * nsplit;
  T* ob = out + (static_cast<size_t>(b) * h + kvh * group) * d;
  for (int e = threadIdx.x; e < group * d; e += kThreads) {
    const int g = e / d;
    float mx = kNegInf;
    for (int s = 0; s < live; ++s)
      mx = fmaxf(mx, part_ml[((part0 + s) * group + g) * 2]);
    float a = 0.f, sum = 0.f;
    for (int s = 0; s < live; ++s) {
      const float f = expf(part_ml[((part0 + s) * group + g) * 2] - mx);
      a = fmaf(part_o[(part0 + s) * group * d + e], f, a);
      sum = fmaf(part_ml[((part0 + s) * group + g) * 2 + 1], f, sum);
    }
    ob[e] = from_f32<T>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int DPL>
void launch(const void* q, const void* kp, const void* vp, const int* tables,
            const int* lens, void* out, float* part_o, float* part_ml, int b,
            int h, int hk, int num_blocks, int bs, int w, int nsplit,
            float sm_scale, cudaStream_t stream) {
  paged_split_kernel<T, DPL><<<dim3(b, hk, nsplit), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lens, part_o, part_ml, h, hk,
      num_blocks, bs, w, nsplit, sm_scale);
  paged_merge_kernel<T><<<dim3(b, hk), kThreads, 0, stream>>>(
      part_o, part_ml, lens, static_cast<T*>(out), h, hk, DPL * 32, bs, w,
      nsplit);
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* t,
             const int* l, void* out, float* po, float* pml, int b, int h,
             int hk, int d, int nb, int bs, int w, int nsplit, float scale,
             cudaStream_t s) {
  if (d == 64)
    launch<T, 2>(q, kp, vp, t, l, out, po, pml, b, h, hk, nb, bs, w, nsplit,
                 scale, s);
  else if (d == 128)
    launch<T, 4>(q, kp, vp, t, l, out, po, pml, b, h, hk, nb, bs, w, nsplit,
                 scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_paged_split_tokens() { return kSplitTokens; }

// part_o: (B, HK, nsplit, G, D) f32 and part_ml: (B, HK, nsplit, G, 2)
// f32 scratch, nsplit >= ceil(table_width * block_size / split tokens).
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lens, void* out, void* part_o,
    void* part_ml, int b, int h, int hk, int d, int num_blocks,
    int block_size, int table_width, int nsplit, float sm_scale, int dtype,
    void* stream) {
  if (b <= 0) return 0;
  if (hk <= 0 || h % hk != 0 || h / hk > kMaxGroup || block_size <= 0 ||
      table_width <= 0 ||
      nsplit * kSplitTokens < table_width * block_size ||
      !aligned16(q) || !aligned16(k_pool) || !aligned16(v_pool))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == kF32)
    return dispatch<float>(q, k_pool, v_pool, t, l, out, po, pml, b, h, hk, d,
                           num_blocks, block_size, table_width, nsplit,
                           sm_scale, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, t, l, out, po, pml, b,
                                   h, hk, d, num_blocks, block_size,
                                   table_width, nsplit, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
