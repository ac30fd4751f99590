// Split-over-the-sequence decode attention ("flash decoding"), shared by
// the paged kernel (K2, paged_attention.cu) and the contiguous-cache
// kernel (K5, decode_attention.cu). The two differ only in where token
// `pos` of sequence `b` lives, and in how its K/V row dequantizes, which
// a small address policy supplies:
//
//   struct Policy {
//     static constexpr int kScale;          // kNoScale, kHeadScale or
//                                           // kRowScale (below)
//     __device__ int length(int b) const;   // live tokens of sequence b
//     // element offset of (b, pos, kv head) row start; false when the row
//     // must not be read (the paged table points outside the pool)
//     __device__ bool row(int b, int pos, int kvh, size_t* off) const;
//     // (k, v) dequant scales: of KV head kvh (kHeadScale, read once per
//     // CTA) or of pool row `row` = offset / D (kRowScale, read beside
//     // the row: one f32 pair, the same address for the whole warp)
//     __device__ float2 scales(int kvh, size_t row) const;
//   };
//
// The cache element type C is q's type T (float pools; without scales the
// loop has no dequant multiply, as the TPU kernel's static `has_scales`
// flag keeps it) or int8_t (int8 pools, K2's int8 arm). A scale is
// folded into the score (s * sm_scale * k_scale) and into the
// probability that weights V (p * v_scale), never into each element:
// two multiplies per token and query head instead of 2 * D.
//
// Bound on the H100: bytes. Every live K/V row is read once and used for
// 2 * G * D multiply-adds (G = query heads per KV head, 1..8), a few flops
// per byte, far below the ~295 flop/byte ridge. The floor is the live K/V
// bytes over 3.35 TB/s.
//
// Design: grid (B, HK, splits), each split a kSplitTokens stretch of one
// sequence, so a long sequence spreads over many SMs instead of being
// walked by one CTA. Inside a CTA each of the 4 warps streams its own
// tokens with no block barrier: a lane holds D/32 dims of the G queries in
// registers (G, a template parameter, is the group rounded up to 1, 2, 4
// or 8: rows past the group hold a zero query and are never written, so a
// group of 3 runs as 4 and one of 5..7 as 8), loads the matching D/32 dims of 4 K
// and 4 V rows at once (several loads in flight per lane), reduces the
// 4 x G dot products with interleaved shuffle chains, and updates its own
// running max m, sum l and accumulator in f32 registers once per 4 tokens
// (TPU kernel's per-block online softmax, a 4-token block). The warps
// then merge through shared memory and each split writes (m, l, acc) to a
// small f32 scratch; a second kernel merges the splits, rescaling by
// exp(m_s - m). Only positions below length(b) are ever read. An int8
// row is D bytes: a lane loads its D/32 bytes (2 or 4), so a warp still
// reads each row as one coalesced stretch.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace split_decode {

enum ScaleMode : int { kNoScale = 0, kHeadScale = 1, kRowScale = 2 };

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;   // query heads per KV head (1..8)
constexpr int kUnroll = 4;     // K/V rows each warp loads at once
constexpr int kSplitTokens = 128;

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

// One split: part_o[b, kvh, split] (group, D) unnormalised accumulator and
// part_ml[b, kvh, split] (group, 2) = (running max, running sum). G is the
// register capacity (>= group = h / hk); C the cache element type.
template <typename T, typename C, int DPL, int G, typename Policy>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                 const C* __restrict__ vc, Policy policy,
                 float* __restrict__ part_o, float* __restrict__ part_ml,
                 int h, int hk, int nsplit, float sm_scale) {
  constexpr int D = DPL * 32;
  constexpr int kScale = Policy::kScale;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = h / hk;
  const int len = policy.length(b);
  const int t0 = split * kSplitTokens;
  if (t0 >= len) return;  // the merge reads only splits below len
  const int t1 = min(t0 + kSplitTokens, len);
  // a KV head's static dequant scales, once per CTA
  float ks_head = 1.f, vs_head = 1.f;
  if constexpr (kScale == kHeadScale) {
    const float2 sc = policy.scales(kvh, 0);
    ks_head = sc.x;
    vs_head = sc.y;
  }

  float qr[G][DPL];
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = qr[g][i] = 0.f;
    if (g < group)
      load_pack<T, DPL>(
          q + (static_cast<size_t>(b) * h + kvh * group + g) * D +
              lane * DPL,
          qr[g]);
  }

  for (int base = t0 + warp * kUnroll; base < t1;
       base += kWarps * kUnroll) {
    float kf[kUnroll][DPL], vf[kUnroll][DPL];
    float ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u;
      size_t off = 0;
      ok[u] = pos < t1 && policy.row(b, pos, kvh, &off);
      ksc[u] = ks_head;
      vsc[u] = vs_head;
      if (ok[u]) {
        if constexpr (kScale == kRowScale) {
          const float2 sc = policy.scales(kvh, off / D);
          ksc[u] = sc.x;
          vsc[u] = sc.y;
        }
        off += lane * DPL;
        load_pack<C, DPL>(kc + off, kf[u]);
        load_pack<C, DPL>(vc + off, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
    // all kUnroll x G dot products first, reduced across the warp as
    // independent shuffle chains (they overlap instead of queueing)
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float acc_s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc_s = fmaf(qr[g][i], kf[u][i], acc_s);
        s[u][g] = acc_s;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
    // each token's score multiplier: sm_scale, times its K dequant scale
    float qs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      qs[u] = kScale == kNoScale ? sm_scale : sm_scale * ksc[u];
    // one online-softmax update per group for the kUnroll tokens (ok is
    // uniform over the warp: same position, same row)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g] * qs[u]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float p[kUnroll], pv[kUnroll];
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? expf(s[u][g] * qs[u] - m_new) : 0.f;
        ps += p[u];
        // the weight of V's row: p, times its V dequant scale
        pv[u] = kScale == kNoScale ? p[u] : p[u] * vsc[u];
      }
      l[g] = alpha * l[g] + ps;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(pv[u], vf[u][i], a);
        acc[g][i] = a;
      }
    }
  }

  // merge the warps of this CTA
  __shared__ float w_ml[kWarps][G][2];
  __shared__ float w_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      w_ml[warp][g][0] = m[g];
      w_ml[warp][g][1] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) w_acc[warp][g][lane * DPL + i] = acc[g][i];
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
template <typename T, typename Policy>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ part_o,
                 const float* __restrict__ part_ml, Policy policy,
                 T* __restrict__ out, int h, int hk, int d, int nsplit) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = h / hk;
  const int len = policy.length(b);
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

template <typename T, typename C, int DPL, int G, typename Policy>
void launch(const void* q, const void* kc, const void* vc, Policy policy,
            void* out, float* part_o, float* part_ml, int b, int h, int hk,
            int nsplit, float sm_scale, cudaStream_t stream) {
  split_kernel<T, C, DPL, G, Policy>
      <<<dim3(b, hk, nsplit), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const C*>(kc),
          static_cast<const C*>(vc), policy, part_o, part_ml, h, hk, nsplit,
          sm_scale);
  merge_kernel<T, Policy><<<dim3(b, hk), kThreads, 0, stream>>>(
      part_o, part_ml, policy, static_cast<T*>(out), h, hk, DPL * 32,
      nsplit);
}

template <typename T, typename C, int DPL, typename Policy>
int launch_group(const void* q, const void* kc, const void* vc,
                 Policy policy, void* out, float* part_o, float* part_ml,
                 int b, int h, int hk, int nsplit, float scale,
                 cudaStream_t s) {
  switch (h / hk) {
    case 1:
      launch<T, C, DPL, 1>(q, kc, vc, policy, out, part_o, part_ml, b, h, hk,
                           nsplit, scale, s);
      break;
    case 2:
      launch<T, C, DPL, 2>(q, kc, vc, policy, out, part_o, part_ml, b, h, hk,
                           nsplit, scale, s);
      break;
    case 3:
    case 4:
      launch<T, C, DPL, 4>(q, kc, vc, policy, out, part_o, part_ml, b, h, hk,
                           nsplit, scale, s);
      break;
    case 5:
    case 6:
    case 7:
    case 8:
      launch<T, C, DPL, 8>(q, kc, vc, policy, out, part_o, part_ml, b, h, hk,
                           nsplit, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C, typename Policy>
int dispatch_dim(const void* q, const void* kc, const void* vc,
                 Policy policy, void* out, float* part_o, float* part_ml,
                 int b, int h, int hk, int d, int nsplit, float scale,
                 cudaStream_t s) {
  if (d == 64)
    return launch_group<T, C, 2>(q, kc, vc, policy, out, part_o, part_ml, b,
                                 h, hk, nsplit, scale, s);
  if (d == 128)
    return launch_group<T, C, 4>(q, kc, vc, policy, out, part_o, part_ml, b,
                                 h, hk, nsplit, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype code of q and the output, head dim and group size h / hk (1..8)
// -> the template instance, over pools of q's dtype or, with Int8Cache,
// int8 pools; returns the launch status (cudaGetLastError), or
// cudaErrorInvalidValue for an unsupported dtype, head dim or group.
template <bool Int8Cache = false, typename Policy>
int dispatch(const void* q, const void* kc, const void* vc, Policy policy,
             void* out, float* part_o, float* part_ml, int b, int h, int hk,
             int d, int nsplit, float scale, int dtype, cudaStream_t s) {
  if (dtype == kF32)
    return dispatch_dim<float, std::conditional_t<Int8Cache, int8_t, float>>(
        q, kc, vc, policy, out, part_o, part_ml, b, h, hk, d, nsplit, scale,
        s);
  if (dtype == kBF16)
    return dispatch_dim<__nv_bfloat16,
                        std::conditional_t<Int8Cache, int8_t, __nv_bfloat16>>(
        q, kc, vc, policy, out, part_o, part_ml, b, h, hk, d, nsplit, scale,
        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace split_decode
}  // namespace ptt
