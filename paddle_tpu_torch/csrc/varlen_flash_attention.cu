// Varlen (packed) flash attention forward (K3) for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/varlen_flash_attention.py, `_varlen_fwd`
// -> `_fwd_kernel` (sequences packed back to back as (T, H, D) with
// cu_seqlens prefix sums; attention never crosses a segment; causal masks
// are bottom-right aligned per segment, rel_q = pos - start_q + len_k -
// len_q; optional per-segment sliding window; GQA; dead tiles skipped;
// writes out and the per-row log-sum-exp).
//
// Bound on the H100: bytes for the serving shapes (a 128-token chunk per
// segment against its cached context: ~2 flops per K/V byte per query
// head), operations for long prefills (4 * H * D flops per live (q, k)
// pair against the q/k/v bytes).
//
// Design: grid (q tiles of 64 rows, H). Each CTA finds its rows'
// segments by binary search in cu_seqlens_q, derives the contiguous key
// range those rows can see (segment bounds, the causal diagonal of its
// last row, the window edge of its first row) and walks only that range
// in 64-key tiles. Per tile it first computes the segment-id / relative-
// position mask from indices alone and skips the tile with no live pair
// before loading any K/V byte (the TPU kernel's run map, built in-kernel
// here instead of by XLA). Online softmax statistics stay in f32.
// - bf16: the products run on the tensor cores (WMMA 16x16x16, bf16
//   operands, f32 accumulation). Each of the 4 warps owns 16 query rows;
//   scores go through shared memory for the masked online softmax, P is
//   rounded to bf16 before P.V as in the TPU kernel, and the f32 output
//   accumulator lives in shared memory, rescaled per row by each tile.
// - f32: CUDA-core FMA (no f32 tensor-core path that keeps full f32
//   precision); each thread owns a 4x4 score micro-tile (rows ty + 16 i,
//   columns tx + 16 j, so shared-memory reads do not collide on banks)
//   and a 4 x D/16 slice of the output in registers.
#include <mma.h>

#include "common.cuh"

using namespace ptt;
namespace wmma = nvcuda::wmma;

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kDMax = 128;
static_assert(kBQ == kBK, "copy_tile / load_rows copy 64-row tiles");

// Segment of packed position pos (0 <= pos < cu[nseg]): the largest s with
// cu[s] <= pos, which is searchsorted(cu[1:], pos, side="right").
__device__ __forceinline__ int find_seg(const int* __restrict__ cu, int nseg,
                                        int pos) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cu[mid] <= pos)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool live_pair(int qs, int qr, int ks, int kr,
                                          int causal, int window) {
  if (qs != ks || qs < 0) return false;
  if (causal) {
    if (qr < kr) return false;
    if (window > 0 && kr <= qr - window) return false;
  }
  return true;
}

// Segment id and bottom-right relative position of the CTA's query rows
// (padding rows get ids no key has).
__device__ void query_rows(const int* __restrict__ cu_q,
                           const int* __restrict__ cu_k, int nseg, int tq,
                           int q0, int* qseg, int* qrel) {
  for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
    const int qi = q0 + r;
    if (qi < tq) {
      const int s = find_seg(cu_q, nseg, qi);
      qseg[r] = s;
      qrel[r] = qi - cu_q[s] + (cu_k[s + 1] - cu_k[s]) - (cu_q[s + 1] - cu_q[s]);
    } else {
      qseg[r] = -1;
      qrel[r] = -(1 << 30);
    }
  }
}

// The contiguous key range [lo, hi) the CTA's rows can see: their
// segments' keys, cut at the last row's causal diagonal and the first
// row's window edge (keys of the segments in between all stay inside).
__device__ void key_range(const int* __restrict__ cu_k, int tq, int tk,
                          int q0, const int* qseg, const int* qrel,
                          int causal, int window, int* range) {
  const int last = min(q0 + kBQ, tq) - 1 - q0;
  const int s_lo = qseg[0];
  const int s_hi = qseg[last];
  int lo = cu_k[s_lo];
  int hi = cu_k[s_hi + 1];
  if (causal) {
    const int diag = cu_k[s_hi] + qrel[last] + 1;
    hi = min(hi, max(diag, s_hi > s_lo ? cu_k[s_hi] : 0));
    if (window > 0) {
      const int edge = cu_k[s_lo] + qrel[0] - window + 1;
      lo = max(lo, s_hi > s_lo ? min(edge, cu_k[s_lo + 1]) : edge);
    }
  }
  range[0] = lo;
  range[1] = min(hi, tk);
}

// Segment ids / relative positions of one key tile; returns (to every
// thread of the CTA) whether any (query, key) pair of the tile is live.
__device__ bool key_tile(const int* __restrict__ cu_k, int nseg, int k0,
                         int khi, const int* qseg, const int* qrel,
                         int* kseg, int* krel, int causal, int window) {
  for (int c = threadIdx.x; c < kBK; c += blockDim.x) {
    const int kj = k0 + c;
    if (kj < khi) {
      const int s = find_seg(cu_k, nseg, kj);
      kseg[c] = s;
      krel[c] = kj - cu_k[s];
    } else {
      kseg[c] = -2;
      krel[c] = 1 << 30;
    }
  }
  __syncthreads();
  bool any = false;
  for (int idx = threadIdx.x; idx < kBQ * kBK; idx += blockDim.x) {
    const int r = idx / kBK;
    const int c = idx - r * kBK;
    any |= live_pair(qseg[r], qrel[r], kseg[c], krel[c], causal, window);
  }
  return __syncthreads_or(any);
}

// ------------------------------------------------------------------ bf16
// Tensor-core path. Shared memory (bytes): Q, K, V tiles bf16 with rows
// padded to 136 elements (WMMA wants 16-byte multiples, the pad spreads
// banks), per-warp f32 scores 16x68, per-warp bf16 P 16x72, per-warp f32
// output accumulator 16x132, and the index arrays.
constexpr int kWarpsTC = 4;
constexpr int kThreadsTC = 32 * kWarpsTC;
constexpr int kLdT = kDMax + 8;  // Q/K/V tile row stride (bf16)
constexpr int kLdS = kBK + 4;    // score row stride (f32)
constexpr int kLdP = kBK + 8;    // P row stride (bf16)
constexpr int kLdO = kDMax + 4;  // output accumulator row stride (f32)

size_t smem_bytes_tc() {
  return sizeof(__nv_bfloat16) *
             (3ull * kBQ * kLdT + static_cast<size_t>(kBQ) * kLdP) +
         sizeof(float) * (static_cast<size_t>(kBQ) * kLdS + kBQ * kLdO) +
         sizeof(int) * (2 * kBQ + 2 * kBK);
}

// dst[r][c] = src row (row0 + r, head), rows past limit zero; 16-byte
// copies (d % 8 == 0 and 16-byte aligned rows).
__device__ __forceinline__ void copy_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int row0,
                                          int limit, int heads, int head,
                                          int d) {
  const int vpr = d / 8;
  for (int idx = threadIdx.x; idx < kBQ * vpr; idx += blockDim.x) {
    const int r = idx / vpr;
    const int c = (idx - r * vpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + (static_cast<size_t>(row0 + r) * heads + head) * d + c);
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = val;
  }
}

__global__ void __launch_bounds__(kThreadsTC)
    varlen_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ cu_q,
                           const int* __restrict__ cu_k,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int tq, int tk, int nseg,
                           int h, int hk, int d, int causal, int window,
                           float sm_scale) {
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int kvh = head / (h / hk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * kLdT;
  __nv_bfloat16* vs = ks + kBK * kLdT;
  __nv_bfloat16* ps = vs + kBK * kLdT;                   // [BQ][kLdP]
  float* ss = reinterpret_cast<float*>(ps + kBQ * kLdP);  // [BQ][kLdS]
  float* os = ss + kBQ * kLdS;                            // [BQ][kLdO]
  int* qseg = reinterpret_cast<int*>(os + kBQ * kLdO);
  int* qrel = qseg + kBQ;
  int* kseg = qrel + kBQ;
  int* krel = kseg + kBK;
  __shared__ int krange[2];

  query_rows(cu_q, cu_k, nseg, tq, q0, qseg, qrel);
  copy_tile(q, qs, q0, tq, h, head, d);
  for (int i = threadIdx.x; i < kBQ * kLdO; i += blockDim.x) os[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0)
    key_range(cu_k, tq, tk, q0, qseg, qrel, causal, window, krange);
  __syncthreads();
  const int klo = krange[0];
  const int khi = krange[1];

  // lane pair (2r, 2r+1) owns row r of the warp's 16 rows, half a row each
  const int r = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  float m = kNegInf, l = 0.f;
  const int ksteps = d / 16;

  for (int k0 = klo; k0 < khi; k0 += kBK) {
    if (!key_tile(cu_k, nseg, k0, khi, qseg, qrel, kseg, krel, causal,
                  window))
      continue;  // dead tile: no K/V bytes read
    copy_tile(k, ks, k0, khi, hk, kvh, d);
    copy_tile(v, vs, k0, khi, hk, kvh, d);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows
    float* sw = ss + warp * 16 * kLdS;
    for (int nt = 0; nt < kBK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < ksteps; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(a, qs + warp * 16 * kLdT + kk * 16, kLdT);
        wmma::load_matrix_sync(bf, ks + nt * 16 * kLdT + kk * 16, kLdT);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(sw + nt * 16, acc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // masked online softmax over the tile, P -> bf16, rescale the row
    const float* srow = ss + r * kLdS;
    float sv[kBK / 2];
    bool ok[kBK / 2];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int c = half * (kBK / 2) + j;
      ok[j] = live_pair(qseg[r], qrel[r], kseg[c], krel[c], causal, window);
      sv[j] = ok[j] ? srow[c] * sm_scale : kNegInf;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float rs = 0.f;
    __nv_bfloat16* prow = ps + r * kLdP;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const float p = ok[j] ? expf(sv[j] - m_new) : 0.f;
      prow[half * (kBK / 2) + j] = __float2bfloat16_rn(p);
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    const float alpha = expf(m - m_new);
    l = alpha * l + rs;
    m = m_new;
    float* orow = os + r * kLdO;
    for (int c = half; c < d; c += 2) orow[c] *= alpha;
    __syncwarp();

    // O += P V for the warp's 16 rows
    float* ow = os + warp * 16 * kLdO;
    for (int nt = 0; nt < ksteps; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, ow + nt * 16, kLdO, wmma::mem_row_major);
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(a, ps + warp * 16 * kLdP + kk * 16, kLdP);
        wmma::load_matrix_sync(bf, vs + kk * 16 * kLdT + nt * 16, kLdT);
        wmma::mma_sync(acc, a, bf, acc);
      }
      wmma::store_matrix_sync(ow + nt * 16, acc, kLdO, wmma::mem_row_major);
    }
    __syncthreads();  // the next tile overwrites K, V and the key indices
  }

  const int qi = q0 + r;
  if (qi < tq) {
    const float lc = fmaxf(l, 1e-30f);
    const float* orow = os + r * kLdO;
    __nv_bfloat16* dst = out + (static_cast<size_t>(qi) * h + head) * d;
    for (int c = half; c < d; c += 2) dst[c] = __float2bfloat16_rn(orow[c] / lc);
    if (half == 0) lse[static_cast<size_t>(head) * tq + qi] = m + logf(lc);
  }
}

// ------------------------------------------------------------------- f32
// CUDA-core path: 256 threads, each owning a 4x4 score micro-tile and a
// 4 x D/16 slice of the output accumulator in registers.
constexpr int kThreadsF = 256;
constexpr int kRows = kBQ / 16;    // score rows per thread
constexpr int kCols = kBK / 16;    // score columns per thread
constexpr int kDPer = kDMax / 16;  // output columns per thread
constexpr int kQS = kDMax + 1;     // padded row stride of the Q / K tiles
constexpr int kSS = kBK + 1;       // padded row stride of the P tile

size_t smem_bytes_f32() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * kQS + kBK * kQS +
                          kBK * kDMax + kBQ * kSS) +
         sizeof(int) * (2 * kBQ + 2 * kBK);
}

// dst[r][c] = src row (row0 + r, head), rows past limit zero.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          float* dst, int stride, int row0,
                                          int limit, int heads, int head,
                                          int d) {
  const int vpr = d / 4;
  for (int idx = threadIdx.x; idx < kBQ * vpr; idx += blockDim.x) {
    const int r = idx / vpr;
    const int c = (idx - r * vpr) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit)
      val = *reinterpret_cast<const float4*>(
          src + (static_cast<size_t>(row0 + r) * heads + head) * d + c);
    dst[r * stride + c] = val.x;
    dst[r * stride + c + 1] = val.y;
    dst[r * stride + c + 2] = val.z;
    dst[r * stride + c + 3] = val.w;
  }
}

__global__ void __launch_bounds__(kThreadsF)
    varlen_fwd_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ cu_q,
                          const int* __restrict__ cu_k,
                          float* __restrict__ out, float* __restrict__ lse,
                          int tq, int tk, int nseg, int h, int hk, int d,
                          int causal, int window, float sm_scale) {
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int kvh = head / (h / hk);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][kQS]
  float* ks = qs + kBQ * kQS;     // [BK][kQS]
  float* vs = ks + kBK * kQS;     // [BK][kDMax]
  float* ps = vs + kBK * kDMax;   // [BQ][kSS]
  int* qseg = reinterpret_cast<int*>(ps + kBQ * kSS);
  int* qrel = qseg + kBQ;
  int* kseg = qrel + kBQ;
  int* krel = kseg + kBK;
  __shared__ int krange[2];

  query_rows(cu_q, cu_k, nseg, tq, q0, qseg, qrel);
  load_rows(q, qs, kQS, q0, tq, h, head, d);
  __syncthreads();
  if (tid == 0)
    key_range(cu_k, tq, tk, q0, qseg, qrel, causal, window, krange);
  __syncthreads();
  const int klo = krange[0];
  const int khi = krange[1];

  float m[kRows], l[kRows], acc[kRows][kDPer];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;
  }
  const int nd = d / 16;

  for (int k0 = klo; k0 < khi; k0 += kBK) {
    if (!key_tile(cu_k, nseg, k0, khi, qseg, qrel, kseg, krel, causal,
                  window))
      continue;  // dead tile: no K/V bytes read
    load_rows(k, ks, kQS, k0, khi, hk, kvh, d);
    load_rows(v, vs, kDMax, k0, khi, hk, kvh, d);
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
        const int c = tx + 16 * j;
        ok[j] = live_pair(qseg[r], qrel[r], kseg[c], krel[c], causal, window);
        s[i][j] = ok[j] ? s[i][j] * sm_scale : kNegInf;
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
    const int qi = q0 + ty + 16 * i;
    if (qi < tq) {
      const float lc = fmaxf(l[i], 1e-30f);
      float* orow = out + (static_cast<size_t>(qi) * h + head) * d;
#pragma unroll
      for (int j = 0; j < kDPer; ++j)
        if (j < nd) orow[tx + 16 * j] = acc[i][j] / lc;
      if (tx == 0) lse[static_cast<size_t>(head) * tq + qi] = m[i] + logf(lc);
    }
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

}  // namespace

extern "C" int ptt_varlen_flash_attention(
    const void* q, const void* k, const void* v, const void* cu_q,
    const void* cu_k, void* out, void* lse, int tq, int tk, int nseg, int h,
    int hk, int d, int causal, int window, float sm_scale, int dtype,
    void* stream) {
  if (tq <= 0) return 0;
  if (nseg <= 0 || hk <= 0 || h % hk != 0 || d <= 0 || d > kDMax ||
      d % 16 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cq = static_cast<const int*>(cu_q);
  const int* ck = static_cast<const int*>(cu_k);
  float* l = static_cast<float*>(lse);
  const dim3 grid((tq + kBQ - 1) / kBQ, h);
  if (dtype == kBF16) {
    static bool configured = false;
    const size_t bytes = smem_bytes_tc();
    if (int e = set_smem(varlen_fwd_bf16_kernel, bytes, &configured)) return e;
    varlen_fwd_bf16_kernel<<<grid, kThreadsTC, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), cq, ck,
        static_cast<__nv_bfloat16*>(out), l, tq, tk, nseg, h, hk, d, causal,
        window, sm_scale);
  } else if (dtype == kF32) {
    static bool configured = false;
    const size_t bytes = smem_bytes_f32();
    if (int e = set_smem(varlen_fwd_f32_kernel, bytes, &configured)) return e;
    varlen_fwd_f32_kernel<<<grid, kThreadsF, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), cq, ck, static_cast<float*>(out), l, tq,
        tk, nseg, h, hk, d, causal, window, sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
