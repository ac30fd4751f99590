// The f32 flash-attention forward tile loop on the tensor cores, shared by
// the varlen kernel (K3, varlen_flash_attention.cu) and the dense kernel
// (K4, flash_attention.cu). Both products run as 3xTF32 on mma.sync
// m16n8k8 (tf32x3.cuh, the helpers of the fused f32 backward), which keeps
// f32 results. The two kernels differ only in which keys a CTA walks and
// which (query row, key) pairs are live, which a small policy supplies:
//
//   struct Policy {
//     // called by every thread of the CTA for each key tile of the walk,
//     // in order, one tile ahead of the products; kDead skips the tile
//     // before any K/V byte is read, kFull says every pair of it is live
//     // (no mask). It may synchronise the CTA and may write index set
//     // `set` (0 or 1), which live() of the same tile then reads.
//     __device__ int tile(int k0, int set);
//     // whether query row r of the CTA sees key c of the tile at k0
//     __device__ bool live(int r, int k0, int c, int set) const;
//   };
//
// Design, at a padded head width D of 64 or 128 (K3 zero-fills narrower
// heads): 128 threads over a 64-row query tile, each warp owning 16 rows
// (rows g and g + 8 of its m16 tiles), its 16 x 64 scores and 16 x D output
// accumulator in registers (32 + 64 floats a thread at D = 128: no other
// accumulator, so two CTAs share an SM at D = 128 and three at D = 64, the
// most whose registers need no spill; scripts/torch_f32_fwd_variants.py).
// Shared memory holds one Q, one K and one V tile, f32, rows padded by 4
// floats (3 x 33.8 KB at D = 128). One key tile:
//   wait K, barrier   (every warp is past the last tile's P V: V is free)
//   copy V (cp.async), which lands while
//     S = Q K^T       tf32x3::rows_by_rows, A = the warp's Q rows
//     mask, online softmax on the accumulator (the row's max over the quad
//                     by two shuffles; exp2 in one MUFU instruction)
//     the policy tests the next tile
//   wait V, barrier   (every warp is past S: K is free)
//   copy the next live K tile, which lands while
//     O += P V        tf32x3::acc_by_rows, A = P (the accumulator itself)
// so each copy runs under one of the two products. Every output is written
// once, by one CTA: two calls are bit-equal. Writes the output and the
// per-row log-sum-exp; a row with no live key gives zeros and lse ~ -1e30.
#pragma once

#include "common.cuh"
#include "flash_mma.cuh"
#include "tf32x3.cuh"

namespace ptt {
namespace flash_f32 {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
static_assert(kBK == tf32x3::kRows, "a score accumulator is 64 keys wide");
// tile states (varlen_seg.cuh's TileState values)
constexpr int kDead = 0;
constexpr int kPartial = 1;
constexpr int kFull = 2;

// Shared memory at padded head width D: Q, K, V tiles of [64][D + 4]
// floats (a kernel may append its own after them).
template <int D>
struct Smem {
  static constexpr int LD = D + 4;
  static constexpr int q_off = 0;
  static constexpr int k_off = kBQ * LD;
  static constexpr int v_off = k_off + kBK * LD;
  static constexpr int floats = v_off + kBK * LD;
  static constexpr size_t bytes = sizeof(float) * floats;
  static_assert(LD % 32 == 4, "padded rows");
};

// 64 rows of width d <= D (a multiple of 4) from src (row i at src + i *
// stride) into a [64][D + 4] tile by cp.async; rows at or past `limit`
// and the columns from d to D are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride, int row0, int limit,
                                          int d) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 4;
    const bool ok = row0 + r < limit && c < d;
    flash::cp_async16(
        dst + r * (D + 4) + c,
        ok ? src + static_cast<size_t>(row0 + r) * stride + c : src, ok);
  }
}

// From the key tile at *k0 on, in steps of kBK below hi, the first whose
// state is not kDead: *k0 moves to it; kDead when none is left.
template <typename Policy>
__device__ __forceinline__ int next_tile(Policy& policy, int* k0, int hi,
                                         int set) {
  for (; *k0 < hi; *k0 += kBK) {
    const int state = policy.tile(*k0, set);
    if (state != kDead) return state;
  }
  return kDead;
}

// One CTA: query rows [0, nq) at qb (row i at qb + i * q_stride) against
// keys [lo, hi) at kb / vb (key j at kb + j * kv_stride), head width d <=
// D; output row i at out + i * out_stride, its log-sum-exp at lse[i].
// smem holds Smem<D>::bytes.
template <int D, typename Policy>
__device__ __forceinline__ void attend(
    const float* __restrict__ qb, size_t q_stride, int nq,
    const float* __restrict__ kb, const float* __restrict__ vb,
    size_t kv_stride, int lo, int hi, int d, float scale, Policy& policy,
    float* __restrict__ out, size_t out_stride, float* __restrict__ lse,
    float* smem) {
  using S = Smem<D>;
  constexpr int kNtS = kBK / 8;  // score n-tiles of a warp
  constexpr int kNtO = D / 8;    // output n-tiles of a warp
  float* qs = smem + S::q_off;
  float* ks = smem + S::k_off;
  float* vs = smem + S::v_off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tig = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // the thread's rows r0, r0 + 8

  load_tile<D>(qs, qb, q_stride, 0, nq, d);
  int k0 = lo;
  int set = 0;
  int state = next_tile(policy, &k0, hi, set);
  if (state != kDead) load_tile<D>(ks, kb, kv_stride, k0, hi, d);
  flash::cp_async_commit();

  float o[kNtO][4];
#pragma unroll
  for (int nd = 0; nd < kNtO; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of scaled scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  const float scale_log2 = scale * flash::kLog2e;

  while (state != kDead) {
    flash::cp_async_wait<0>();
    __syncthreads();  // K (and Q) landed; every warp is past P V: V is free
    load_tile<D>(vs, vb, kv_stride, k0, hi, d);
    flash::cp_async_commit();

    float sc[kNtS][4];
    tf32x3::rows_by_rows<D>(qs, warp * 16, ks, sc);  // S = Q K^T
    if (state == kPartial) {
      // dead pairs to -inf, which exp sends to 0
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!policy.live(r0 + (e >> 1) * 8, k0, nt * 8 + tig * 2 + (e & 1),
                           set))
            sc[nt][e] = -INFINITY;
    }
    // online softmax: rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3); the four
    // threads of a quad share a row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * half], sc[nt][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx * scale);
      const float alpha = flash::exp2_ftz((m[half] - m_new) * flash::kLog2e);
      const float ml = m_new * flash::kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float p = flash::exp2_ftz(fmaf(sc[nt][e], scale_log2, -ml));
          sc[nt][e] = p;
          rs += p;
        }
      l[half] = alpha * l[half] + rs;
      m[half] = m_new;
#pragma unroll
      for (int nd = 0; nd < kNtO; ++nd) {
        o[nd][2 * half] *= alpha;
        o[nd][2 * half + 1] *= alpha;
      }
    }

    // the next live tile, tested while V is in flight (index set set ^ 1)
    int nk0 = k0 + kBK;
    const int nstate = next_tile(policy, &nk0, hi, set ^ 1);
    flash::cp_async_wait<0>();
    __syncthreads();  // V landed; every warp is past S: K is free
    if (nstate != kDead) load_tile<D>(ks, kb, kv_stride, nk0, hi, d);
    flash::cp_async_commit();
    tf32x3::acc_by_rows<D>(sc, vs, o);  // O += P V
    k0 = nk0;
    state = nstate;
    set ^= 1;
  }
  flash::cp_async_wait<0>();  // the Q copy, when no tile was live

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = r0 + half * 8;
    if (r < nq) {
      const float lc = fmaxf(lt, 1e-30f);
      const float inv = 1.f / lc;
      float* dst = out + static_cast<size_t>(r) * out_stride + tig * 2;
#pragma unroll
      for (int nd = 0; nd < kNtO; ++nd)
        if (nd * 8 < d)
          *reinterpret_cast<float2*>(dst + nd * 8) =
              make_float2(o[nd][2 * half] * inv, o[nd][2 * half + 1] * inv);
      if (tig == 0) lse[r] = m[half] + logf(lc);
    }
  }
}

}  // namespace flash_f32
}  // namespace ptt
