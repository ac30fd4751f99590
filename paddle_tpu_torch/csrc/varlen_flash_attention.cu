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
// here instead of by XLA). Online softmax statistics stay in f32. The
// segment logic (live pairs, key ranges, tile tests) lives in
// varlen_seg.cuh, shared with the backward kernels K8a/K8b; rows at or
// past cu_seqlens_q[-1] are padding, see nothing and write zeros.
// - bf16: the products run on the tensor cores (WMMA 16x16x16, bf16
//   operands, f32 accumulation). Each of the 4 warps owns 16 query rows;
//   scores go through shared memory for the masked online softmax, P is
//   rounded to bf16 before P.V as in the TPU kernel, and the f32 output
//   accumulator lives in shared memory, rescaled per row by each tile.
// - f32: CUDA-core FMA (no f32 tensor-core path that keeps full f32
//   precision), the tile loop of flash_f32.cuh, shared with K4.
#include <mma.h>

#include "common.cuh"
#include "flash_f32.cuh"
#include "varlen_seg.cuh"

using namespace ptt;
using namespace ptt::varlen;
namespace wmma = nvcuda::wmma;

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kDMax = 128;
static_assert(kBQ == kBK && kBQ == flash_f32::kBQ && kBK == flash_f32::kBK &&
                  kBQ == kTile,
              "copy_tile copies 64-row tiles; the f32 path and varlen_seg.cuh "
              "share the tiles");

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
// CUDA-core path: flash_f32.cuh's tile loop; the policy below walks the
// segment-aware tiles with the index arrays appended to its shared memory.
size_t smem_bytes_f32() {
  return flash_f32::kSmemBytes + sizeof(int) * (2 * kBQ + 2 * kBK);
}

struct SegmentTiles {
  const int* cu_k;
  int nseg, khi, causal, window;
  const int *qseg, *qrel;
  int *kseg, *krel;

  __device__ bool tile(int k0) {
    return key_tile(cu_k, nseg, k0, khi, qseg, qrel, kseg, krel, causal,
                    window);
  }
  __device__ bool live(int r, int, int c) const {
    return live_pair(qseg[r], qrel[r], kseg[c], krel[c], causal, window);
  }
};

__global__ void __launch_bounds__(flash_f32::kThreads)
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

  extern __shared__ float smem[];
  int* qseg = reinterpret_cast<int*>(
      reinterpret_cast<char*>(smem) + flash_f32::kSmemBytes);
  int* qrel = qseg + kBQ;
  int* kseg = qrel + kBQ;
  int* krel = kseg + kBK;
  __shared__ int krange[2];

  query_rows(cu_q, cu_k, nseg, tq, q0, qseg, qrel);
  __syncthreads();
  if (threadIdx.x == 0)
    key_range(cu_k, tq, tk, q0, qseg, qrel, causal, window, krange);
  __syncthreads();
  SegmentTiles tiles{cu_k, nseg, krange[1], causal, window,
                     qseg, qrel, kseg, krel};
  const size_t row = static_cast<size_t>(h) * d;
  flash_f32::attend(q + (static_cast<size_t>(q0) * h + head) * d, row,
                    min(kBQ, tq - q0), k + static_cast<size_t>(kvh) * d,
                    v + static_cast<size_t>(kvh) * d,
                    static_cast<size_t>(hk) * d, krange[0], krange[1], d,
                    sm_scale, tiles,
                    out + (static_cast<size_t>(q0) * h + head) * d, row,
                    lse + static_cast<size_t>(head) * tq + q0, smem);
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
    varlen_fwd_f32_kernel<<<grid, flash_f32::kThreads, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), cq, ck, static_cast<float*>(out), l, tq,
        tk, nseg, h, hk, d, causal, window, sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
