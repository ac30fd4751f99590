// Flash attention forward (K4) for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, `_flash_fwd` ->
// `_fwd_kernel` with the tile logic of `_run_full`, `_kv_band_clamp` and
// `_mask_for_block` (dense (B, S, H, D) attention; GQA reads the shared KV
// head; causal is bottom-right aligned, k <= q + (sk - sq); keys past sk
// are masked; a causal sliding window keeps k >= q + (sk - sq) - window + 1;
// fully masked rows give zeros; writes out and the per-row log-sum-exp).
//
// Bound on the H100: operations for prefill (4 * D flops per live (q, k)
// pair against 2 * D K/V bytes read per KV head), bytes for short queries
// over long keys.
//
// Design: grid (q tiles of 64 rows, H, B), the q tiles with the most live
// keys launched first. Each CTA derives from indices alone the contiguous
// key range its rows can see (the causal diagonal of its last row, the
// window edge of its first row: `_kv_band_clamp` computed in-kernel) and
// walks only that range in 64-key tiles, so no byte of a dead tile is
// read. Tiles wholly inside the band skip the mask (`_run_full`'s `full`).
// - bf16: tensor cores through `mma.sync` m16n8k16 (bf16 operands, f32
//   accumulation), FlashAttention-2 layout: each of the 4 warps owns 16
//   query rows, keeps its Q fragments, the 16 x 64 scores and the 16 x D
//   output accumulator in registers; the scores' accumulator fragments are
//   re-packed in place as the A operand of P.V (P rounded to bf16, as the
//   TPU kernel rounds P to v's dtype; the row sum l uses the unrounded P).
//   K and V tiles stream through shared memory with cp.async, two stages,
//   so the next tile loads while this one computes; V's B fragments come
//   from ldmatrix.trans.
// - f32: CUDA-core FMA (no f32 tensor-core path keeps full f32 precision),
//   the tile loop of flash_f32.cuh, shared with K3.
#include "common.cuh"
#include "flash_f32.cuh"
#include "flash_mma.cuh"

using namespace ptt;
using namespace ptt::flash;

namespace {

static_assert(kBQ == flash_f32::kBQ && kBK == flash_f32::kBK,
              "the f32 path uses flash_f32.cuh's tiles");

template <int D>
constexpr size_t smem_bytes_tc() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kBQ + 4 * kBK) *
         (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 2)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, Dims s) {
  constexpr int LD = D + 8;  // shared row stride: 16-byte rows, no bank clash
  constexpr int kSteps = D / 16;
  constexpr int kNtS = kBK / 8;  // score n-tiles per warp
  constexpr int kNtO = D / 8;    // output n-tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * LD;   // [2][kBK][LD]
  __nv_bfloat16* vs = ks + 2 * kBK * LD;  // [2][kBK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (s.h / s.hk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;

  const size_t q_stride = static_cast<size_t>(s.h) * D;
  const size_t kv_stride = static_cast<size_t>(s.hk) * D;
  const __nv_bfloat16* qb =
      q + (static_cast<size_t>(b) * s.sq * s.h + head) * D;
  const __nv_bfloat16* kb =
      k + (static_cast<size_t>(b) * s.sk * s.hk + kvh) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<size_t>(b) * s.sk * s.hk + kvh) * D;

  int lo, hi;
  key_range(s, q0, &lo, &hi);
  const int ntiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  load_tile<D, LD>(qs, qb, q_stride, q0, s.sq);
  if (ntiles > 0) {
    load_tile<D, LD>(ks, kb, kv_stride, lo, hi);
    load_tile<D, LD>(vs, vb, kv_stride, lo, hi);
  }
  cp_async_commit();

  float o[kNtO][4];
#pragma unroll
  for (int i = 0; i < kNtO; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of scaled scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  uint32_t qf[kSteps][4];
  const float scale_log2 = s.scale * kLog2e;
  const int r0 = q0 + warp * 16 + g;  // the thread's two rows: r0, r0 + 8

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = lo + t * kBK;
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      load_tile<D, LD>(ks + (stage ^ 1) * kBK * LD, kb, kv_stride, k0 + kBK,
                       hi);
      load_tile<D, LD>(vs + (stage ^ 1) * kBK * LD, vb, kv_stride, k0 + kBK,
                       hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      const __nv_bfloat16* qw = qs + (warp * 16 + g) * LD + tig * 2;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        qf[kk][0] = lds32(qw + kk * 16);
        qf[kk][1] = lds32(qw + 8 * LD + kk * 16);
        qf[kk][2] = lds32(qw + kk * 16 + 8);
        qf[kk][3] = lds32(qw + 8 * LD + kk * 16 + 8);
      }
    }
    const __nv_bfloat16* kt = ks + stage * kBK * LD;
    const __nv_bfloat16* vt = vs + stage * kBK * LD;

    // S = Q K^T (raw dot products) for the warp's 16 rows x 64 keys
    float sc[kNtS][4];
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const __nv_bfloat16* kr = kt + (nt * 8 + g) * LD + tig * 2;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        mma_bf16(sc[nt], qf[kk], lds32(kr + kk * 16),
                 lds32(kr + kk * 16 + 8));
    }

    // mask (boundary tiles only): dead pairs to -inf, which exp sends to 0
    if (!full_tile(s, q0, k0)) {
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8;
          const int c = k0 + nt * 8 + tig * 2 + (e & 1);
          if (!band_live(s, r, c)) sc[nt][e] = -INFINITY;
        }
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
      const float m_new = fmaxf(m[half], mx * s.scale);
      const float alpha = exp2f((m[half] - m_new) * kLog2e);
      const float ml = m_new * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt) {
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float p = exp2f(fmaf(sc[nt][e], scale_log2, -ml));
          sc[nt][e] = p;
          rs += p;
        }
      }
      l[half] = alpha * l[half] + rs;
      m[half] = m_new;
#pragma unroll
      for (int nd = 0; nd < kNtO; ++nd) {
        o[nd][2 * half] *= alpha;
        o[nd][2 * half + 1] *= alpha;
      }
    }

    // O += P V: P (bf16) straight from the score fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const __nv_bfloat16* vr =
          vt + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < kNtO; nd += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vr + nd * 8);
        mma_bf16(o[nd], a, bf[0], bf[1]);
        mma_bf16(o[nd + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = r0 + half * 8;
    if (r < s.sq) {
      const float lc = fmaxf(lt, 1e-30f);
      const float inv = 1.f / lc;
      __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * s.sq + r) * s.h +
                                  head) * D + tig * 2;
#pragma unroll
      for (int nd = 0; nd < kNtO; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8) =
            __floats2bfloat162_rn(o[nd][2 * half] * inv,
                                  o[nd][2 * half + 1] * inv);
      if (tig == 0)
        lse[(static_cast<size_t>(b) * s.h + head) * s.sq + r] =
            m[half] + logf(lc);
    }
  }
}

// ------------------------------------------------------------------- f32
// CUDA-core path: flash_f32.cuh's tile loop over the band's key range;
// every tile in the range holds a live pair, so none is skipped.
struct BandTiles {
  Dims s;
  int q0;

  __device__ bool tile(int) { return true; }
  __device__ bool live(int r, int k0, int c) const {
    return band_live(s, q0 + r, k0 + c);
  }
};

__global__ void __launch_bounds__(flash_f32::kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, Dims s, int d) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (s.h / s.hk);
  extern __shared__ float smem[];

  int lo, hi;
  key_range(s, q0, &lo, &hi);
  BandTiles tiles{s, q0};
  const size_t row = static_cast<size_t>(s.h) * d;
  const size_t kv0 = (static_cast<size_t>(b) * s.sk * s.hk + kvh) * d;
  flash_f32::attend(
      q + ((static_cast<size_t>(b) * s.sq + q0) * s.h + head) * d, row,
      min(kBQ, s.sq - q0), k + kv0, v + kv0, static_cast<size_t>(s.hk) * d,
      lo, hi, d, s.scale, tiles,
      out + ((static_cast<size_t>(b) * s.sq + q0) * s.h + head) * d, row,
      lse + (static_cast<size_t>(b) * s.h + head) * s.sq + q0, smem);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, const Dims& s, dim3 grid, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t bytes = smem_bytes_tc<D>();
  if (int e = set_smem(flash_fwd_bf16_kernel<D>, bytes, &configured))
    return e;
  flash_fwd_bf16_kernel<D><<<grid, kThreadsTC, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, HK, D), out like q, lse (B, H, Sq) f32; all
// contiguous. D is 64 or 128; window 0 means none (needs causal).
extern "C" int ptt_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int b, int sq, int sk, int h, int hk,
                                   int d, int causal, int window,
                                   float sm_scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (sk < 0 || hk <= 0 || h % hk != 0 || (d != 64 && d != 128) ||
      window < 0 || (window > 0 && !causal) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims s{sq, sk, h, hk, causal, window, sk - sq, sm_scale};
  float* l = static_cast<float*>(lse);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  if (dtype == kBF16)
    return d == 64 ? launch_bf16<64>(q, k, v, out, l, s, grid, st)
                   : launch_bf16<128>(q, k, v, out, l, s, grid, st);
  if (dtype == kF32) {
    static bool configured = false;
    constexpr size_t bytes = flash_f32::kSmemBytes;
    if (int e = set_smem(flash_fwd_f32_kernel, bytes, &configured)) return e;
    flash_fwd_f32_kernel<<<grid, flash_f32::kThreads, bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), l, s, d);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
