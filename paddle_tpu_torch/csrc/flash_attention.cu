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

using namespace ptt;

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kDMax = 128;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == flash_f32::kBQ && kBK == flash_f32::kBK,
              "the f32 path uses flash_f32.cuh's tiles");

struct Dims {
  int sq, sk, h, hk;
  int causal, window;  // window 0: none
  int off;             // causal offset sk - sq (bottom-right alignment)
  float scale;
};

// The key range [lo, hi) the rows [q0, q0 + kBQ) of one CTA can see.
__device__ __forceinline__ void key_range(const Dims& s, int q0, int* lo,
                                          int* hi) {
  int l = 0, u = s.sk;
  if (s.causal) {
    const int q_last = min(q0 + kBQ, s.sq) - 1;
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

// Every (row, key) pair of the tile is live for every real row.
__device__ __forceinline__ bool full_tile(const Dims& s, int q0, int k0) {
  if (k0 + kBK > s.sk) return false;
  if (!s.causal) return true;
  if (k0 + kBK - 1 > q0 + s.off) return false;
  const int q_last = min(q0 + kBQ, s.sq) - 1;
  return s.window <= 0 || k0 > q_last + s.off - s.window;
}

// ------------------------------------------------------------------ bf16
constexpr int kWarpsTC = 4;
constexpr int kThreadsTC = 32 * kWarpsTC;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// 64 rows of D bf16 from src (row i at src + i * stride) into a shared
// tile of row stride LD; rows at or past `limit` are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0,
                                          int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreadsTC) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<size_t>(row0 + r) * stride + c : src,
               ok);
  }
}

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
