// Split-over-the-sequence decode attention for Hopper, shared by the paged
// kernel (K2, paged_attention.cu: float pools, float pools with static
// scales, int8 pools with static or per-row scales) and the
// contiguous-cache kernel (K5, decode_attention.cu). The two differ only
// in where token `pos` of sequence `b` lives and in how its K/V row
// dequantizes, which a small address policy supplies:
//
//   struct Policy {
//     static constexpr int kScale;          // kNoScale, kHeadScale or
//                                           // kRowScale (below)
//     __device__ int length(int b) const;   // live tokens of sequence b
//     // the row of token pos in the (rows, HK, D) view of the cache, or
//     // -1 when it must not be read (the paged table points outside the
//     // pool): its scores are masked and its copy reads nothing
//     __device__ int row(int b, int pos) const;
//     const float* k_scale;  // (HK,) for kHeadScale; one per (row, head)
//     const float* v_scale;  // for kRowScale; unused for kNoScale
//   };
//
// The cache element type C is q's type T (float pools) or int8_t (K2's
// int8 pools). A scale is folded into the score (s * sm_scale * k_scale)
// and into the probability that weights V (p * v_scale), never into each
// element: two multiplies per token and query head instead of 2 * D.
//
// Bound on the H100: bytes. Every live K/V row is read once and used for
// 2 * G * D multiply-adds (G = query heads per KV head, 1..8), a few flops
// per byte, far below the ~295 flop/byte ridge. The floor is the live K/V
// bytes (plus q, out, the table and the scales) over 3.35 TB/s.
//
// Design. One launch; grid (splits, B * HK). Each CTA takes one stretch
// of one sequence for one KV head; the host-side planner
// (ops/split_decode.py, `plan`) sizes the stretch from B * HK and the
// table's reach so that the grid fills the card without knowing the
// lengths, which live on the card. A CTA
//   1. maps its stretch's positions to pool rows once, into shared memory,
//      before the first copy (the paged table is read per position only
//      below the length; a stale id past the pool maps to -1);
//   2. streams the K and V rows of its head through a ring of kStages
//      shared-memory stages with 16-byte cp.async (the per-row int8 scales
//      beside them with 4-byte cp.async), kStages - 1 tiles in flight
//      ahead of the arithmetic;
//   3. computes with each of its 4 warps on its own rows of every tile:
//      - bf16 queries (over bf16 or int8 rows): tensor cores, mma.sync
//        m16n8k16. S = Q K^T with the group's query heads as the rows of
//        Q (padded to 16 with zero queries) and 16 tokens as the columns;
//        an online softmax per head over the quad that holds its row; then
//        O += P V with P split into two bf16 terms (p = hi + lo, exact to
//        ~2^-16 relative), so the result keeps f32 probabilities as the
//        TPU kernel does. int8 rows turn into bf16 exactly (|x| <= 128)
//        in registers, as their fragments load.
//      - f32 queries (the parity path): CUDA cores, f32 throughout; a lane
//        holds D/32 dims of each query head and reduces 4 x G dot products
//        with interleaved shuffle chains.
//   4. merges its warps through shared memory; a sequence with one live
//      stretch writes its output there. Otherwise the CTA writes its
//      (max, sum, accumulator) to a small f32 scratch and takes a ticket;
//      the last CTA of the (sequence, KV head) pair resets the ticket to 0
//      for the next call and merges the partials in split order. Every
//      sum runs in a fixed order, so two calls give bit-equal outputs.
// Scores live in the log2 domain (scaled by log2 e) so each exponential
// is one exp2.
#pragma once

#include <type_traits>

#include "flash_mma.cuh"

namespace ptt {
namespace split_decode {

enum ScaleMode : int { kNoScale = 0, kHeadScale = 1, kRowScale = 2 };

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;       // query heads per KV head (1..8)
constexpr int kStretchUnit = 64;   // a stretch is a multiple of this
constexpr int kMaxStretch = 2048;  // tokens of one CTA (its row table)
constexpr int kMaxSplits = 256;    // CTAs of one pair (the merge's table)
constexpr int kRingBudget = 73728;  // shared bytes the ring may take

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ constexpr int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Shared-memory layout of one instance: T the query type, C the cache's.
template <typename T, typename C, int D>
struct Geometry {
  // tensor cores for bf16 queries, CUDA cores for f32 ones
  static constexpr bool kMma = std::is_same_v<T, bf16>;
  static constexpr bool kInt8 = std::is_same_v<C, int8_t>;
  // tokens per ring stage: 16 per warp on the tensor cores, 8 (two groups
  // of 4) per warp on the CUDA cores
  static constexpr int kRows = kMma ? 64 : 32;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(C));
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte copies a row
  // Row strides in shared memory, padded so that no fragment load of the
  // tensor cores has a bank conflict: bf16 rows that ldmatrix reads by 16
  // bytes of 8 rows take 16 more bytes; an int8 K row, read 16 bytes per
  // thread from 2 rows of a quarter-warp, is 64 bytes off the next modulo
  // 128; an int8 V row, read from rows 0, 2, 4 and 6 of a quarter-warp,
  // takes 16 more bytes. A warp reads an f32 row as one contiguous
  // stretch, unpadded.
  static constexpr int kStrideK =
      std::is_same_v<C, bf16> ? kRowBytes + 16
                              : (kInt8 ? round_up(kRowBytes + 1, 128) - 64
                                       : kRowBytes);
  static constexpr int kStrideV =
      std::is_same_v<C, bf16> || kInt8 ? kRowBytes + 16 : kRowBytes;
  static constexpr int kVOffset = kRows * kStrideK;
  static constexpr int kScaleOffset = kVOffset + kRows * kStrideV;
  static constexpr int kStageBytes =
      round_up(kScaleOffset + 2 * kRows * 4, 128);
  static constexpr int kStages =
      clamp_int(kRingBudget / kStageBytes, 2, 4);
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kLd = D + 8;  // bf16 elements of a padded row
  // after the loop: the warps' partials, then the splits' weights and sums
  static constexpr int kMergeBytes =
      kWarps * kMaxGroup * (D + 2) * 4 + (2 * kMaxSplits + 1) * kMaxGroup * 4;

  static constexpr size_t smem_bytes(int stretch) {
    const int loop = kRingBytes + 4 * stretch;
    return static_cast<size_t>(loop > kMergeBytes ? loop : kMergeBytes);
  }
};

// Issue the copies of the K and V rows [r0, r0 + kRows) of the stretch (n
// live rows) into one ring stage; rows past n or without a pool row are
// zero-filled and read nothing.
template <class Geo, int D, typename C, typename Policy>
__device__ __forceinline__ void load_stage(unsigned char* st, const C* kc,
                                           const C* vc, const Policy& pol,
                                           const int* rows, int r0, int n,
                                           int hk, int kvh) {
  for (int c = threadIdx.x; c < Geo::kRows * Geo::kChunks; c += kThreads) {
    const int r = c / Geo::kChunks;
    const int part = c - r * Geo::kChunks;
    const int row = r0 + r < n ? rows[r0 + r] : -1;
    const size_t off =
        row >= 0 ? (static_cast<size_t>(row) * hk + kvh) * D : 0;
    const char* ks = reinterpret_cast<const char*>(kc + off) + part * 16;
    const char* vs = reinterpret_cast<const char*>(vc + off) + part * 16;
    flash::cp_async16(st + r * Geo::kStrideK + part * 16, ks, row >= 0);
    flash::cp_async16(st + Geo::kVOffset + r * Geo::kStrideV + part * 16, vs,
                      row >= 0);
  }
  if constexpr (Policy::kScale == kRowScale) {
    const int r = threadIdx.x;
    if (r < Geo::kRows) {
      const int row = r0 + r < n ? rows[r0 + r] : -1;
      const size_t i = row >= 0 ? static_cast<size_t>(row) * hk + kvh : 0;
      float* sc = reinterpret_cast<float*>(st + Geo::kScaleOffset);
      flash::cp_async4(sc + r, pol.k_scale + i, row >= 0);
      flash::cp_async4(sc + Geo::kRows + r, pol.v_scale + i, row >= 0);
    }
  }
}

// Exact int8 -> bf16 without a conversion instruction: byte i of w (w
// already XORed with 0x80808080, so the byte is u = x + 128) goes into the
// mantissa of the float 2^23 + u, and 2^23 + 128 comes off. The result is
// an integer below 2^8 in magnitude, so its float's top half is its bf16.
__device__ __forceinline__ uint32_t int8_f32_bits(uint32_t w, int i) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i)) - 8388736.f);
}

// bf16x2 of byte i of the (XORed) words lo and hi: lo's in the low half.
__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi,
                                              int i) {
  return __byte_perm(int8_f32_bits(lo, i), int8_f32_bits(hi, i), 0x7632);
}

// The tensor-core path (bf16 queries). Thread (g = lane / 4, tig = lane %
// 4) holds query head g's row of every fragment (rows g + 8 are padding).
// bf16 rows load their fragments by ldmatrix. int8 rows turn into bf16 in
// registers, each thread reading 16 bytes of a row at once, so the
// reduction dims and the output columns run in a permuted order (below)
// that both sides of each product share.
template <typename C, int D, int Scale>
struct MmaPath {
  using Geo = Geometry<bf16, C, D>;
  static constexpr bool kInt8 = Geo::kInt8;
  static constexpr int kK = D / 16;  // k-steps of S = Q K^T
  static constexpr int kN = D / 8;   // n-tiles of O = P V
  static constexpr int kLd = Geo::kLd;
  uint32_t qf[kK][4];
  float o[kN][4];
  float m, l;  // head g's running max (log2 domain), this thread's sum

  // The dim of k-step kk's pair e (0: k = 2 tig, 2 tig + 1; 1: k = 2 tig
  // + 8, + 9). bf16: 16 kk + 8 e + 2 tig. int8: thread tig reads bytes
  // [16 tig, 16 tig + 16) of each 64-byte block of a K row, 4 k-steps a
  // block, so k-step kk = 4 j + i takes dims 64 j + 16 tig + 4 i + 2 e.
  static __device__ int q_dim(int kk, int e, int tig) {
    if constexpr (kInt8)
      return 64 * (kk >> 2) + 16 * tig + 4 * (kk & 3) + 2 * e;
    else
      return 16 * kk + 8 * e + 2 * tig;
  }

  // The output column of n-tile nd's column n (0..7). bf16: 8 nd + n.
  // int8: thread g reads bytes [g D/8, (g + 1) D/8) of a V row, one per
  // n-tile, so B's column n of n-tile nd is dim n D/8 + nd.
  static __device__ int out_dim(int nd, int n) {
    if constexpr (kInt8)
      return n * kN + nd;
    else
      return 8 * nd + n;
  }

  __device__ void init(const bf16* qh, int group) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      qf[kk][0] = qf[kk][1] = qf[kk][2] = qf[kk][3] = 0u;
      if (g < group) {
        qf[kk][0] = flash::lds32(qh + g * D + q_dim(kk, 0, tig));
        qf[kk][2] = flash::lds32(qh + g * D + q_dim(kk, 1, tig));
      }
    }
#pragma unroll
    for (int nd = 0; nd < kN; ++nd)
      o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
    m = kNegInf;
    l = 0.f;
  }

  // S = Q K^T for the warp's 16 rows (tile rows k0, k0 + 16): head g's
  // scores of tokens 2 tig + {0, 1} (s[0]) and 8 + 2 tig + {0, 1} (s[1]).
  __device__ void scores(const unsigned char* st, int k0, float (*s)[4]) {
    const int lane = threadIdx.x & 31;
    if constexpr (kInt8) {
      const int g = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned char* kr =
            st + (k0 + 8 * j + g) * Geo::kStrideK + 16 * tig;
#pragma unroll
        for (int blk = 0; blk < D / 64; ++blk) {
          const uint4 w = *reinterpret_cast<const uint4*>(kr + 64 * blk);
          const uint32_t x[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                 w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            flash::mma_bf16(
                s[j], qf[4 * blk + i],
                __byte_perm(int8_f32_bits(x[i], 0), int8_f32_bits(x[i], 1),
                            0x7632),
                __byte_perm(int8_f32_bits(x[i], 2), int8_f32_bits(x[i], 3),
                            0x7632));
        }
      }
    } else {
      const bf16* kt = reinterpret_cast<const bf16*>(st) + k0 * kLd;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t bf[4];
        flash::b_frags<kLd>(bf, kt, 0, kk, lane);
        flash::mma_bf16(s[0], qf[kk], bf[0], bf[1]);
        flash::mma_bf16(s[1], qf[kk], bf[2], bf[3]);
      }
    }
  }

  // O += P V for the warp's 16 rows, P as two bf16 A fragments.
  __device__ void values(const unsigned char* st, int k0,
                         const uint32_t* hi, const uint32_t* lo) {
    const int lane = threadIdx.x & 31;
    if constexpr (kInt8) {
      // rows 2 tig, 2 tig + 1 (b0) and 2 tig + 8, 2 tig + 9 (b1): bytes
      // [g D/8, (g + 1) D/8) of each, n-tile nd's column g in byte nd
      const int g = lane >> 2, tig = lane & 3;
      constexpr int kWords = kN / 4;
      uint32_t x[4][kWords];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned char* vr = st + Geo::kVOffset +
                                  (k0 + 2 * tig + (e & 1) + 8 * (e >> 1)) *
                                      Geo::kStrideV +
                                  g * kN;
        if constexpr (kWords == 4) {
          const uint4 w = *reinterpret_cast<const uint4*>(vr);
          x[e][0] = w.x;
          x[e][1] = w.y;
          x[e][2] = w.z;
          x[e][3] = w.w;
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(vr);
          x[e][0] = w.x;
          x[e][1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < kWords; ++i) x[e][i] ^= 0x80808080u;
      }
#pragma unroll
      for (int nd = 0; nd < kN; ++nd) {
        const uint32_t b0 = int8_pair(x[0][nd >> 2], x[1][nd >> 2], nd & 3);
        const uint32_t b1 = int8_pair(x[2][nd >> 2], x[3][nd >> 2], nd & 3);
        flash::mma_bf16(o[nd], hi, b0, b1);
        flash::mma_bf16(o[nd], lo, b0, b1);
      }
    } else {
      const bf16* vr = reinterpret_cast<const bf16*>(st + Geo::kVOffset) +
                       (k0 + (lane & 15)) * kLd + (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < kN; nd += 2) {
        uint32_t bf[4];
        flash::ldmatrix_x4_trans(bf, vr + nd * 8);
        flash::mma_bf16(o[nd], hi, bf[0], bf[1]);
        flash::mma_bf16(o[nd], lo, bf[0], bf[1]);
        flash::mma_bf16(o[nd + 1], hi, bf[2], bf[3]);
        flash::mma_bf16(o[nd + 1], lo, bf[2], bf[3]);
      }
    }
  }

  // The warp's 16 rows of the tile whose first stretch row is r0.
  __device__ void step(const unsigned char* st, const int* rows, int r0,
                       int n, float qscale, float vscale) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tig = lane & 3;
    const int w0 = r0 + 16 * warp;
    if (w0 >= n) return;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    scores(st, 16 * warp, s);

    // online softmax over the quad that holds the head's row
    const float* sc = reinterpret_cast<const float*>(st + Geo::kScaleOffset);
    float p[4];
    bool ok[4];
    float mx = kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = (e >> 1) * 8 + tig * 2 + (e & 1);  // warp-relative
      ok[e] = w0 + t < n && rows[w0 + t] >= 0;
      float f = qscale;
      if constexpr (Scale == kRowScale) f *= sc[16 * warp + t];
      p[e] = s[e >> 1][e & 1] * f;
      if (ok[e]) mx = fmaxf(mx, p[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = flash::exp2_ftz(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ok[e] ? flash::exp2_ftz(p[e] - m_new) : 0.f;
      rs += p[e];
      const int t = (e >> 1) * 8 + tig * 2 + (e & 1);
      if constexpr (Scale == kRowScale)
        p[e] *= sc[Geo::kRows + 16 * warp + t];
      else if constexpr (Scale == kHeadScale)
        p[e] *= vscale;
    }
    l = alpha * l + rs;
    m = m_new;
    // P (the V-weighted probabilities) as hi + lo bf16 A fragments
    uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float h0 = __bfloat162float(__float2bfloat16_rn(p[2 * j]));
      const float h1 = __bfloat162float(__float2bfloat16_rn(p[2 * j + 1]));
      hi[2 * j] = flash::pack_bf16(h0, h1);
      lo[2 * j] = flash::pack_bf16(p[2 * j] - h0, p[2 * j + 1] - h1);
    }
#pragma unroll
    for (int nd = 0; nd < kN; ++nd) {
      o[nd][0] *= alpha;
      o[nd][1] *= alpha;
    }
    values(st, 16 * warp, hi, lo);
  }

  // The warp's (max, sum) and accumulator of each head into shared memory.
  __device__ void publish(float* w_acc, float* w_ml) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, tig = lane & 3;
    float sum = l + __shfl_xor_sync(0xffffffffu, l, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    float* wa = w_acc + (warp * kMaxGroup + g) * D;
#pragma unroll
    for (int nd = 0; nd < kN; ++nd) {
      wa[out_dim(nd, 2 * tig)] = o[nd][0];
      wa[out_dim(nd, 2 * tig + 1)] = o[nd][1];
    }
    if (tig == 0) {
      w_ml[(warp * kMaxGroup + g) * 2] = m;
      w_ml[(warp * kMaxGroup + g) * 2 + 1] = sum;
    }
  }
};

template <typename C, int N>
__device__ __forceinline__ void load_row(const unsigned char* p, float* out) {
  using V = std::conditional_t<
      N * sizeof(C) == 16, uint4,
      std::conditional_t<N * sizeof(C) == 8, uint2,
                         std::conditional_t<N * sizeof(C) == 4, uint32_t,
                                            uint16_t>>>;
  const V raw = *reinterpret_cast<const V*>(p);
  const C* e = reinterpret_cast<const C*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

// The CUDA-core path (f32 queries): a lane holds dims [lane * DPL, (lane +
// 1) * DPL) of each of the G query-head slots (G: the group rounded up to
// 1, 2, 4 or 8; the spare slots hold zero queries and are never written).
template <typename C, int D, int G, int Scale>
struct FmaPath {
  using Geo = Geometry<float, C, D>;
  static constexpr int DPL = D / 32;
  static constexpr int kUnroll = 4;  // tokens a warp reduces at once
  float qr[G][DPL], acc[G][DPL], m[G], l[G];

  __device__ void init(const float* qh, int group) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = qr[g][i] = 0.f;
      if (g < group)
        load_row<float, DPL>(
            reinterpret_cast<const unsigned char*>(qh + g * D + lane * DPL),
            qr[g]);
    }
  }

  // The warp's 8 rows (two groups of 4) of the tile whose first stretch
  // row is r0.
  __device__ void step(const unsigned char* st, const int* rows, int r0,
                       int n, float qscale, float vscale) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* sc = reinterpret_cast<const float*>(st + Geo::kScaleOffset);
#pragma unroll
    for (int u0 = 0; u0 < 8; u0 += kUnroll) {
      const int base = r0 + 8 * warp + u0;
      if (base >= n) break;
      float kf[kUnroll][DPL], vf[kUnroll][DPL], qs[kUnroll], vs[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tr = 8 * warp + u0 + u;  // tile row
        ok[u] = base + u < n && rows[base + u] >= 0;
        const int off = lane * DPL * sizeof(C);
        load_row<C, DPL>(st + tr * Geo::kStrideK + off, kf[u]);
        load_row<C, DPL>(st + Geo::kVOffset + tr * Geo::kStrideV + off,
                         vf[u]);
        qs[u] = qscale;
        vs[u] = vscale;
        if constexpr (Scale == kRowScale) {
          qs[u] *= sc[tr];
          vs[u] = sc[Geo::kRows + tr];
        }
      }
      // all kUnroll x G dot products first, reduced across the warp as
      // independent shuffle chains
      float s[kUnroll][G];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) a = fmaf(qr[g][i], kf[u][i], a);
          s[u][g] = a;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (ok[u]) mx = fmaxf(mx, s[u][g] * qs[u]);
        const float m_new = fmaxf(m[g], mx);
        const float alpha = exp2f(m[g] - m_new);
        float p[kUnroll], ps = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = ok[u] ? exp2f(s[u][g] * qs[u] - m_new) : 0.f;
          ps += p[u];
          if constexpr (Scale != kNoScale) p[u] *= vs[u];
        }
        l[g] = alpha * l[g] + ps;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[g][i] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vf[u][i], a);
          acc[g][i] = a;
        }
      }
    }
  }

  __device__ void publish(float* w_acc, float* w_ml) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        w_ml[(warp * kMaxGroup + g) * 2] = m[g];
        w_ml[(warp * kMaxGroup + g) * 2 + 1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        w_acc[(warp * kMaxGroup + g) * D + lane * DPL + i] = acc[g][i];
    }
  }
};

template <typename T, typename C, int D, int G, int Scale>
using Path = std::conditional_t<Geometry<T, C, D>::kMma, MmaPath<C, D, Scale>,
                                FmaPath<C, D, G, Scale>>;

// part_o: (B * HK, nsplit, group, D) and part_ml: (B * HK, nsplit, group,
// 2) f32 scratch; tickets: B * HK ints, 0 before and after the launch.
template <typename T, typename C, int D, int G, typename Policy>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                  const C* __restrict__ vc, Policy pol, T* __restrict__ out,
                  float* __restrict__ part_o, float* __restrict__ part_ml,
                  int* __restrict__ tickets, int h, int hk, int stretch,
                  int nsplit, float sm_scale) {
  using Geo = Geometry<T, C, D>;
  constexpr int kScale = Policy::kScale;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int split = blockIdx.x, pair = blockIdx.y;
  const int b = pair / hk, kvh = pair - b * hk;
  const int group = h / hk;
  const int len = pol.length(b);
  T* ob = out + (static_cast<size_t>(b) * h + kvh * group) * D;
  if (len <= 0) {  // no live key: zeros, as the clamped row sum gives
    if (split == 0)
      for (int e = tid; e < group * D; e += kThreads) ob[e] = from_f32<T>(0.f);
    return;
  }
  const int live = (len + stretch - 1) / stretch;
  if (split >= live) return;
  const int t0 = split * stretch;
  const int n = min(stretch, len - t0);

  // the queries' loads go out first: their latency hides behind the
  // table's
  Path<T, C, D, G, kScale> path;
  path.init(q + (static_cast<size_t>(b) * h + kvh * group) * D, group);
  unsigned char* ring = smem;
  int* rows = reinterpret_cast<int*>(smem + Geo::kRingBytes);
  // the stretch's pool rows, once, before the first copy
  for (int i = tid; i < n; i += kThreads) rows[i] = pol.row(b, t0 + i);
  __syncthreads();

  const int ntiles = (n + Geo::kRows - 1) / Geo::kRows;
#pragma unroll
  for (int s = 0; s < Geo::kStages - 1; ++s) {
    if (s < ntiles)
      load_stage<Geo, D>(ring + s * Geo::kStageBytes, kc, vc, pol, rows,
                         s * Geo::kRows, n, hk, kvh);
    flash::cp_async_commit();
  }

  float qscale = sm_scale * flash::kLog2e, vscale = 1.f;
  if constexpr (kScale == kHeadScale) {
    qscale *= pol.k_scale[kvh];
    vscale = pol.v_scale[kvh];
  }
  for (int it = 0; it < ntiles; ++it) {
    flash::cp_async_wait<Geo::kStages - 2>();
    __syncthreads();  // tile `it` landed; every warp left tile it - 1
    const int nxt = it + Geo::kStages - 1;
    if (nxt < ntiles)
      load_stage<Geo, D>(ring + (nxt % Geo::kStages) * Geo::kStageBytes, kc,
                         vc, pol, rows, nxt * Geo::kRows, n, hk, kvh);
    flash::cp_async_commit();
    path.step(ring + (it % Geo::kStages) * Geo::kStageBytes, rows,
              it * Geo::kRows, n, qscale, vscale);
  }
  flash::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge reuses it

  float* w_acc = reinterpret_cast<float*>(smem);
  float* w_ml = w_acc + kWarps * kMaxGroup * D;
  // the last CTA's merge: per split and head its weight and its sum
  float* wt = w_ml + kWarps * kMaxGroup * 2;     // [kMaxSplits][kMaxGroup]
  float* sum_s = wt + kMaxSplits * kMaxGroup;    // [kMaxSplits][kMaxGroup]
  float* den = sum_s + kMaxSplits * kMaxGroup;   // [kMaxGroup]
  path.publish(w_acc, w_ml);
  __syncthreads();

  // this CTA's partial: its warps merged in warp order
  const size_t slot = static_cast<size_t>(pair) * nsplit + split;
  float* po = part_o + slot * group * D;
  float* pml = part_ml + slot * group * 2;
  for (int e = tid; e < group * D; e += kThreads) {
    const int g = e / D, d = e - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, w_ml[(w * kMaxGroup + g) * 2]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(w_ml[(w * kMaxGroup + g) * 2] - mx);
      a = fmaf(w_acc[(w * kMaxGroup + g) * D + d], f, a);
      sum = fmaf(w_ml[(w * kMaxGroup + g) * 2 + 1], f, sum);
    }
    if (live == 1) {
      ob[e] = from_f32<T>(a / fmaxf(sum, 1e-30f));
    } else {
      po[e] = a;
      if (d == 0) {
        pml[g * 2] = mx;
        pml[g * 2 + 1] = sum;
      }
    }
  }
  if (live == 1) return;

  // the last CTA of the pair to finish merges the partials in split order
  // (the release as in a grid-wide barrier: the block's stores, then one
  // thread's fence, then its ticket)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(tickets + pair, 1) == live - 1;
    if (last) tickets[pair] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* po0 = part_o + static_cast<size_t>(pair) * nsplit * group * D;
  const float* pml0 = part_ml + static_cast<size_t>(pair) * nsplit * group * 2;
  for (int i = tid; i < live * group; i += kThreads) {
    const int s = i / group, g = i - s * group;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(pml0) + i);
    wt[s * kMaxGroup + g] = ml.x;
    sum_s[s * kMaxGroup + g] = ml.y;
  }
  __syncthreads();
  if (tid < group) {
    float mx = kNegInf;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, wt[s * kMaxGroup + tid]);
    float sum = 0.f;
    for (int s = 0; s < live; ++s) {
      const float f = exp2f(wt[s * kMaxGroup + tid] - mx);
      wt[s * kMaxGroup + tid] = f;
      sum = fmaf(sum_s[s * kMaxGroup + tid], f, sum);
    }
    den[tid] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  // each column of 4 elements sums its splits in split order, the loads
  // of kBatch splits in flight at a time
  constexpr int kBatch = 16;
  const int cols = group * D / 4;
  const float4* po4 = reinterpret_cast<const float4*>(po0);
  for (int c = tid; c < cols; c += kThreads) {
    const int g = 4 * c / D;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < live; s0 += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (s0 + j < live)
          x[j] = __ldcg(po4 + static_cast<size_t>(s0 + j) * cols + c);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (s0 + j < live) {
          const float w = wt[(s0 + j) * kMaxGroup + g];
          a[0] = fmaf(x[j].x, w, a[0]);
          a[1] = fmaf(x[j].y, w, a[1]);
          a[2] = fmaf(x[j].z, w, a[2]);
          a[3] = fmaf(x[j].w, w, a[3]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) ob[4 * c + i] = from_f32<T>(a[i] / den[g]);
  }
}

struct Launch {
  const void* q;
  const void* kc;
  const void* vc;
  void* out;
  float* part_o;
  float* part_ml;
  int* tickets;
  int b, h, hk, stretch, nsplit;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, int G, typename Policy>
int launch(const Launch& a, const Policy& pol) {
  using Geo = Geometry<T, C, D>;
  auto kernel = decode_kernel<T, C, D, G, Policy>;
  static bool sized = false;
  if (const int e = flash::set_smem(kernel, Geo::smem_bytes(kMaxStretch),
                                    &sized))
    return e;
  kernel<<<dim3(a.nsplit, a.b * a.hk), kThreads, Geo::smem_bytes(a.stretch),
           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.kc),
      static_cast<const C*>(a.vc), pol, static_cast<T*>(a.out), a.part_o,
      a.part_ml, a.tickets, a.h, a.hk, a.stretch, a.nsplit, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The group's register slots on the CUDA cores: 1, 2, 4 or 8 (a group
// that is no power of two runs in the next one's slots); the tensor cores
// take any group in their 16 rows.
template <typename T, typename C, int D, typename Policy>
int launch_group(const Launch& a, const Policy& pol) {
  if constexpr (Geometry<T, C, D>::kMma) {
    return launch<T, C, D, kMaxGroup>(a, pol);
  } else {
    const int g = a.h / a.hk;
    if (g == 1) return launch<T, C, D, 1>(a, pol);
    if (g == 2) return launch<T, C, D, 2>(a, pol);
    if (g <= 4) return launch<T, C, D, 4>(a, pol);
    return launch<T, C, D, 8>(a, pol);
  }
}

// The launch's checks shared by K2 and K5: the plan covers `reach`
// tokens in at most kMaxSplits stretches of a multiple of kStretchUnit,
// the group is 1..8, and q and the caches are 16-byte aligned.
inline bool valid(const Launch& a, long long reach) {
  return a.hk > 0 && a.h % a.hk == 0 && a.h / a.hk <= kMaxGroup &&
         static_cast<long long>(a.b) * a.hk <= 65535 && a.stretch > 0 && a.stretch % kStretchUnit == 0 &&
         a.stretch <= kMaxStretch && a.nsplit > 0 &&
         a.nsplit <= kMaxSplits &&
         static_cast<long long>(a.nsplit) * a.stretch >= reach &&
         aligned16(a.q) && aligned16(a.kc) && aligned16(a.vc);
}

// dtype code of q and the output and head dim -> the template instance,
// over caches of q's dtype or, with Int8Cache, int8 caches; returns the
// launch status (cudaGetLastError), or cudaErrorInvalidValue for an
// unsupported dtype, head dim or group.
template <bool Int8Cache = false, typename Policy>
int dispatch(const Launch& a, const Policy& pol, int d, int dtype) {
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32) {
    using C = std::conditional_t<Int8Cache, int8_t, float>;
    return d == 64 ? launch_group<float, C, 64>(a, pol)
                   : launch_group<float, C, 128>(a, pol);
  }
  if (dtype == kBF16) {
    using C = std::conditional_t<Int8Cache, int8_t, bf16>;
    return d == 64 ? launch_group<bf16, C, 64>(a, pol)
                   : launch_group<bf16, C, 128>(a, pol);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace split_decode
}  // namespace ptt
