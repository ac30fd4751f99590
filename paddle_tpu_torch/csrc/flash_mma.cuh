// Pieces shared by the dense flash-attention kernels, forward (K4,
// flash_attention.cu) and backward (K7, flash_attention_bwd.cu): the
// tile sizes, the live band of (query, key) pairs (bottom-right causal,
// sliding window, keys past sk), and the 16-bit tensor-core building blocks
// (`mma.sync` m16n8k16 with f32 accumulation, `ldmatrix.trans`, 16-byte
// `cp.async` tile staging, and the fragment helpers, which the varlen
// kernel K3 shares; K4, K7 and K8 take the fragment re-packing
// for their `wgmma` products). Keeping the band logic in one place
// keeps the forward and the backward from ever disagreeing on which pairs
// are live (the TPU kernels share `_run_full` for the same reason).
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr int kBQ = 64;  // query rows per CTA (f32 kernels; K7's dq tile)
constexpr int kBK = 64;  // keys per tile (f32 kernels)
constexpr int kDMax = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int sq, sk, h, hk;
  int causal, window;  // window 0: none
  int off;             // causal offset sk - sq (bottom-right alignment)
  float scale;
};

// The key range [lo, hi) the rows [q0, q0 + BQ) of one CTA can see (BQ:
// the tile height, 64 for K7 and the f32 kernels, 128 for K4's bf16
// kernel).
template <int BQ = kBQ>
__device__ __forceinline__ void key_range(const Dims& s, int q0, int* lo,
                                          int* hi) {
  int l = 0, u = s.sk;
  if (s.causal) {
    const int q_last = min(q0 + BQ, s.sq) - 1;
    u = min(u, q_last + s.off + 1);
    if (s.window > 0) l = max(0, q0 + s.off - s.window + 1);
  }
  *lo = l;
  *hi = u;
}

__device__ __forceinline__ bool band_live(const Dims& s, int r, int c) {
  if (c >= s.sk) return false;
  if (s.causal) {
    const int diag = r + s.off;
    if (c > diag) return false;
    if (s.window > 0 && c <= diag - s.window) return false;
  }
  return true;
}

// Every (row, key) pair of the BQ x BK tile is live for every real row.
template <int BQ = kBQ, int BK = kBK>
__device__ __forceinline__ bool full_tile(const Dims& s, int q0, int k0) {
  if (k0 + BK > s.sk) return false;
  if (!s.causal) return true;
  if (k0 + BK - 1 > q0 + s.off) return false;
  const int q_last = min(q0 + BQ, s.sq) - 1;
  return s.window <= 0 || k0 > q_last + s.off - s.window;
}

// bf16 tensor-core building blocks (mma.sync m16n8k16, ldmatrix, cp.async)
constexpr int kWarpsTC = 4;
constexpr int kThreadsTC = 32 * kWarpsTC;

// 16-byte global -> shared copy; nothing is read and zeros are written
// when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 2^x in one MUFU.EX2 (subnormal results flush to zero); exp2f adds the
// instructions that keep them.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2<__nv_bfloat16>(lo, hi);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The B fragments of n-tiles nt and nt + 1 at column block kk, for a B
// operand stored as the rows n of a shared tile of row stride LD (K in
// Q K^T; Q or dO in the backward's K Q^T and V dO^T): b[0], b[1] for nt,
// b[2], b[3] for nt + 1, one ldmatrix.x4 in place of eight 4-byte loads.
template <int LD>
__device__ __forceinline__ void b_frags(uint32_t* b, const __nv_bfloat16* tile,
                                        int nt, int kk, int lane) {
  ldmatrix_x4(b, tile + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
}

// 64 rows of a head of width d <= D (a multiple of 8) from src (row i at
// src + i * stride) into a shared tile of D columns and row stride LD;
// rows at or past `limit` and the columns from d to D are zero-filled, so
// a product over the padded width adds only zeros (the varlen forward K3
// takes any d % 16 == 0 up to 128).
template <int D, int LD>
__device__ __forceinline__ void load_tile_cols(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               size_t stride, int row0,
                                               int limit, int d) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreadsTC) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const bool ok = row0 + r < limit && c < d;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<size_t>(row0 + r) * stride + c : src,
               ok);
  }
}

// Fragment helpers of the backward kernels (K7 and K8): each warp owns 16
// rows of a 64-row tile, thread (g = lane / 4, tig = lane % 4) rows g and
// g + 8.

// 4-byte global -> shared copy, zeros when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// Re-pack accumulator columns [16 kk, 16 kk + 16) as an A fragment of T
// (bf16 or fp16).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void pack_a(uint32_t* a, float (*c)[4], int kk) {
  a[0] = pack2<T>(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2<T>(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Write a warp's 16 x D accumulator rows (r0, r0 + 8) in T (bf16 or
// fp16); `base` is row 0 of the output, rows `stride` apart.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* base, size_t stride,
                                           float (*acc)[4], int r0,
                                           int limit, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r >= limit) continue;
    T* dst = base + static_cast<size_t>(r) * stride + tig * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(dst + nd * 8) =
          pack2<T>(acc[nd][2 * half], acc[nd][2 * half + 1]);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

}  // namespace flash
}  // namespace ptt
