// The f32 flash-attention tile loop on the CUDA cores, shared by the
// varlen kernel (K3, varlen_flash_attention.cu) and the dense kernel (K4,
// flash_attention.cu). It stays on f32 FMA: one TF32 product alone would
// not keep f32 results, but a 3xTF32 split does (big + small operands,
// three tensor-core products; the fused f32 backward, bwd_f32.cuh), which
// is left to the forward's redesign. The two kernels differ only in which
// keys a CTA walks and which (query row, key) pairs are live, which a
// small policy supplies:
//
//   struct Policy {
//     // called by every thread of the CTA for each key tile; false skips
//     // the tile before any K/V byte is read (may synchronise the CTA)
//     __device__ bool tile(int k0);
//     // whether query row r of the CTA sees key c of the tile at k0
//     __device__ bool live(int r, int k0, int c) const;
//   };
//
// Design: 256 threads over a 64-row query tile, each owning a 4x4 score
// micro-tile (rows ty + 16 i, columns tx + 16 j, so shared-memory reads do
// not collide on banks) and a 4 x D/16 slice of the output accumulator in
// registers; Q, K, V and P tiles in padded shared memory; online softmax
// in f32 (running max m, sum l, accumulator rescaled per tile). Writes the
// output and the per-row log-sum-exp; a row with no live key gives zeros.
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash_f32 {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kDMax = 128;
static_assert(kBQ == kBK, "load_rows copies 64-row tiles");
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;    // score rows per thread
constexpr int kCols = kBK / 16;    // score columns per thread
constexpr int kDPer = kDMax / 16;  // output columns per thread
constexpr int kQS = kDMax + 1;     // padded row stride of the Q / K tiles
constexpr int kSS = kBK + 1;       // padded row stride of the P tile

// Shared memory the tiles take (a kernel may append its own after it).
constexpr size_t kSmemBytes =
    sizeof(float) * (static_cast<size_t>(kBQ) * kQS + kBK * kQS +
                     kBK * kDMax + kBQ * kSS);

// dst[r][c] = src row (row0 + r) (row i at src + i * stride), rows at or
// past limit zero.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          float* dst, int ld, size_t stride,
                                          int row0, int limit, int d) {
  const int vpr = d / 4;
  for (int idx = threadIdx.x; idx < kBQ * vpr; idx += blockDim.x) {
    const int r = idx / vpr;
    const int c = (idx - r * vpr) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * stride + c);
    dst[r * ld + c] = val.x;
    dst[r * ld + c + 1] = val.y;
    dst[r * ld + c + 2] = val.z;
    dst[r * ld + c + 3] = val.w;
  }
}

// One CTA: query rows [0, nq) at qb (row i at qb + i * q_stride) against
// keys [lo, hi) at kb / vb (key j at kb + j * kv_stride); output row i at
// out + i * out_stride, its log-sum-exp at lse[i]. smem holds kSmemBytes.
template <typename Policy>
__device__ __forceinline__ void attend(
    const float* __restrict__ qb, size_t q_stride, int nq,
    const float* __restrict__ kb, const float* __restrict__ vb,
    size_t kv_stride, int lo, int hi, int d, float scale, Policy& policy,
    float* __restrict__ out, size_t out_stride, float* __restrict__ lse,
    float* smem) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float* qs = smem;              // [BQ][kQS]
  float* ks = qs + kBQ * kQS;    // [BK][kQS]
  float* vs = ks + kBK * kQS;    // [BK][kDMax]
  float* ps = vs + kBK * kDMax;  // [BQ][kSS]

  load_rows(qb, qs, kQS, q_stride, 0, nq, d);

  float m[kRows], l[kRows], acc[kRows][kDPer];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;
  }
  const int nd = d / 16;

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    if (!policy.tile(k0)) continue;  // dead tile: no K/V bytes read
    load_rows(kb, ks, kQS, kv_stride, k0, hi, d);
    load_rows(vb, vs, kDMax, kv_stride, k0, hi, d);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * kQS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * kQS + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ok[j] = policy.live(r, k0, tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * kSS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDPer; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kSS + c];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        if (j < nd) {
          const float vv = vs[c * kDMax + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float lc = fmaxf(l[i], 1e-30f);
      float* orow = out + static_cast<size_t>(r) * out_stride;
#pragma unroll
      for (int j = 0; j < kDPer; ++j)
        if (j < nd) orow[tx + 16 * j] = acc[i][j] / lc;
      if (tx == 0) lse[r] = m[i] + logf(lc);
    }
  }
}

}  // namespace flash_f32
}  // namespace ptt
