// Flash attention backward for Hopper: K7a (dq) and K7b (dk, dv).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, `_flash_bwd` ->
// `_bwd_dq_kernel` (K7a) and `_bwd_dkv_kernel` (K7b). Both recompute the
// probabilities from the forward's log-sum-exp, P = exp(S * scale - lse),
// and take delta = rowsum(dO * O) (f32, computed by the wrapper):
//   dS = P * (dO V^T - delta) * scale
//   dQ = dS K            dK = dS^T Q            dV = P^T dO
// with the TPU kernel's roundings: P is rounded to dO's dtype before dV,
// dS to K's dtype before dQ and to Q's dtype before dK, every product
// accumulates in f32, and dq, dk, dv are written in the input dtype. The
// live (query, key) pairs are the forward's (flash_mma.cuh): bottom-right
// causal, the sliding-window band, keys past sk never count.
//
// Bound on the H100: operations at training shapes. Per live pair K7a does
// 3 products of D (S, dP, dQ: 6 * D flops) and K7b 4 (S, dP, dV, dK:
// 8 * D flops) against 4 * D (q, dO, dq rows) or 4 * D (k, v, dk, dv rows)
// bytes read or written once.
//
// Design. The TPU grid carries dq (or dk/dv) in scratch across its
// sequential key (or query) axis; here each CTA owns one 64-row tile of
// the output and loops over the tiles of the other side inside the block,
// walking only the band of tiles that holds a live pair (computed from
// indices, as the forward does), so a dead tile costs no byte.
// - K7a: grid (query tiles, H, B), heaviest tiles first. Q and dO stay in
//   shared memory; K and V tiles stream through two cp.async stages.
// - K7b: grid (key tiles, HK, B). One CTA serves a KV head for all G query
//   heads of its group, looping over (head, query tile) and summing their
//   dk/dv in f32 registers: no K/V repeated per query head (the TPU kernel
//   materialises `jnp.repeat`ed K/V and sums afterwards) and no atomics.
//   Q, dO, lse and delta tiles stream through two cp.async stages.
// - bf16: tensor cores through `mma.sync` m16n8k16 in K4's layout: each of
//   the 4 warps owns 16 output rows; the score and dP accumulators (16 x
//   64 per warp) become dS / P in place and are re-packed as the A operand
//   of the next product; the B operands that run along the key (K7a) or
//   query (K7b) axis come from ldmatrix.trans.
// - f32: CUDA-core FMA in the tile shape of flash_f32.cuh (256 threads,
//   each a 4 x 4 micro-tile of scores and a 4 x D/16 slice of the output).
#include "common.cuh"
#include "flash_f32.cuh"
#include "flash_mma.cuh"

using namespace ptt;
using namespace ptt::flash;

namespace {

static_assert(kBQ == flash_f32::kBQ && kBK == flash_f32::kBK,
              "the f32 path uses flash_f32.cuh's tiles");
using bf16 = __nv_bfloat16;

// The query range [lo, hi) that sees at least one of the keys
// [k0, k0 + kBK): the transpose of key_range (`_q_band_clamp`).
__device__ __forceinline__ void query_range(const Dims& s, int k0, int* lo,
                                            int* hi) {
  int l = 0, u = s.sq;
  if (s.causal) {
    l = max(0, k0 - s.off);
    if (s.window > 0) u = min(u, min(k0 + kBK, s.sk) - 1 - s.off + s.window);
  }
  *lo = l;
  *hi = u;
}

// Every pair of the query tile at q0 and the key tile at k0 is live, and
// both tiles are whole (rows past sq would add to dk / dv).
__device__ __forceinline__ bool full_pair(const Dims& s, int q0, int k0) {
  if (q0 + kBQ > s.sq || k0 + kBK > s.sk) return false;
  if (!s.causal) return true;
  if (k0 + kBK - 1 > q0 + s.off) return false;
  return s.window <= 0 || k0 > q0 + kBQ - 1 + s.off - s.window;
}

// ------------------------------------------------------------ K7a bf16
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(2 * kBQ + 4 * kBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 2)
    bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, Dims s) {
  constexpr int LD = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kNtS = kBK / 8;
  constexpr int kNtO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBQ * LD;
  bf16* ks = dos + kBQ * LD;      // [2][kBK][LD]
  bf16* vs = ks + 2 * kBK * LD;   // [2][kBK][LD]

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
  const size_t q_off = (static_cast<size_t>(b) * s.sq * s.h + head) * D;
  const size_t kv_off = (static_cast<size_t>(b) * s.sk * s.hk + kvh) * D;
  const bf16* kb = k + kv_off;
  const bf16* vb = v + kv_off;

  int lo, hi;
  key_range(s, q0, &lo, &hi);
  const int ntiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  load_tile<D, LD>(qs, q + q_off, q_stride, q0, s.sq);
  load_tile<D, LD>(dos, dout + q_off, q_stride, q0, s.sq);
  if (ntiles > 0) {
    load_tile<D, LD>(ks, kb, kv_stride, lo, hi);
    load_tile<D, LD>(vs, vb, kv_stride, lo, hi);
  }
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;  // the thread's rows r0, r0 + 8
  const size_t row0 = (static_cast<size_t>(b) * s.h + head) * s.sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    lse2[half] = r < s.sq ? lse[row0 + r] * kLog2e : 0.f;
    dl[half] = r < s.sq ? delta[row0 + r] : 0.f;
  }
  float acc[kNtO][4];
#pragma unroll
  for (int i = 0; i < kNtO; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float scale_log2 = s.scale * kLog2e;
  const bf16* qw = qs + (warp * 16 + g) * LD + tig * 2;
  const bf16* dw = dos + (warp * 16 + g) * LD + tig * 2;

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
    const bf16* kt = ks + stage * kBK * LD;
    const bf16* vt = vs + stage * kBK * LD;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys
    float sc[kNtS][4], dp[kNtS][4];
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t aq[4], ad[4];
      a_frag<LD>(aq, qw, kk);
      a_frag<LD>(ad, dw, kk);
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt) {
        const bf16* kr = kt + (nt * 8 + g) * LD + tig * 2 + kk * 16;
        const bf16* vr = vt + (nt * 8 + g) * LD + tig * 2 + kk * 16;
        mma_bf16(sc[nt], aq, lds32(kr), lds32(kr + 8));
        mma_bf16(dp[nt], ad, lds32(vr), lds32(vr + 8));
      }
    }

    // P from lse (dead pairs 0), then dS = P (dP - delta) scale in sc
    const bool full = full_tile(s, q0, k0);
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float p = exp2f(fmaf(sc[nt][e], scale_log2, -lse2[half]));
        if (!full &&
            !band_live(s, r0 + half * 8, k0 + nt * 8 + tig * 2 + (e & 1)))
          p = 0.f;
        sc[nt][e] = p * (dp[nt][e] - dl[half]) * s.scale;
      }

    // dQ += dS K (dS rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, sc, kk);
      mma_rows<D, LD>(acc, a, kt, kk, lane);
    }
    __syncthreads();  // the next iteration refills this stage
  }
  store_rows<D>(dq + q_off, q_stride, acc, r0, s.sq, tig);
}

// ------------------------------------------------------------ K7b bf16
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(2 * kBK + 4 * kBQ) * (D + 8) +
         sizeof(float) * 4 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 2)
    bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        Dims s) {
  constexpr int LD = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kNtS = kBQ / 8;  // score n-tiles (queries) per warp
  constexpr int kNtO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBK * LD;
  bf16* qs = vs + kBK * LD;        // [2][kBQ][LD]
  bf16* dos = qs + 2 * kBQ * LD;   // [2][kBQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * kBQ * LD);  // [2][kBQ]
  float* dls = ls + 2 * kBQ;                                 // [2][kBQ]

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = s.h / s.hk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;

  const size_t q_stride = static_cast<size_t>(s.h) * D;
  const size_t kv_stride = static_cast<size_t>(s.hk) * D;
  const size_t kv_off = (static_cast<size_t>(b) * s.sk * s.hk + kvh) * D;

  int lo, hi;
  query_range(s, k0, &lo, &hi);
  const int nqt = hi > lo ? (hi - lo + kBQ - 1) / kBQ : 0;
  const int items = grp * nqt;  // (query head of the group, query tile)

  // stage the Q / dO rows, lse and delta of item t
  auto load_item = [&](int t, int stage) {
    const int head = kvh * grp + t / nqt;
    const int q0 = lo + (t % nqt) * kBQ;
    const size_t q_off = (static_cast<size_t>(b) * s.sq * s.h + head) * D;
    load_tile<D, LD>(qs + stage * kBQ * LD, q + q_off, q_stride, q0, s.sq);
    load_tile<D, LD>(dos + stage * kBQ * LD, dout + q_off, q_stride, q0,
                     s.sq);
    const size_t row0 = (static_cast<size_t>(b) * s.h + head) * s.sq;
    for (int i = threadIdx.x; i < kBQ; i += kThreadsTC) {
      const bool ok = q0 + i < s.sq;
      cp_async4(ls + stage * kBQ + i, lse + (ok ? row0 + q0 + i : 0), ok);
      cp_async4(dls + stage * kBQ + i, delta + (ok ? row0 + q0 + i : 0), ok);
    }
  };

  load_tile<D, LD>(ks, k + kv_off, kv_stride, k0, s.sk);
  load_tile<D, LD>(vs, v + kv_off, kv_stride, k0, s.sk);
  if (items > 0) load_item(0, 0);
  cp_async_commit();

  float adk[kNtO][4], adv[kNtO][4];
#pragma unroll
  for (int i = 0; i < kNtO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;
  const float scale_log2 = s.scale * kLog2e;
  const int kr0 = k0 + warp * 16 + g;  // the thread's keys kr0, kr0 + 8
  const bf16* kw = ks + (warp * 16 + g) * LD + tig * 2;
  const bf16* vw = vs + (warp * 16 + g) * LD + tig * 2;

  for (int t = 0; t < items; ++t) {
    const int stage = t & 1;
    const int q0 = lo + (t % nqt) * kBQ;
    if (t + 1 < items) {
      load_item(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + stage * kBQ * LD;
    const bf16* dot = dos + stage * kBQ * LD;
    const float* lt = ls + stage * kBQ;
    const float* dt = dls + stage * kBQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 64 queries
    float sc[kNtS][4], dp[kNtS][4];
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ak[4], av[4];
      a_frag<LD>(ak, kw, kk);
      a_frag<LD>(av, vw, kk);
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt) {
        const bf16* qr = qt + (nt * 8 + g) * LD + tig * 2 + kk * 16;
        const bf16* dr = dot + (nt * 8 + g) * LD + tig * 2 + kk * 16;
        mma_bf16(sc[nt], ak, lds32(qr), lds32(qr + 8));
        mma_bf16(dp[nt], av, lds32(dr), lds32(dr + 8));
      }
    }

    // P^T in sc (dead pairs 0), dS^T = P^T (dP^T - delta) scale in dp
    const bool full = full_pair(s, q0, k0);
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + tig * 2 + (e & 1);  // query in the tile
        float p = exp2f(fmaf(sc[nt][e], scale_log2, -lt[c] * kLog2e));
        if (!full && !(q0 + c < s.sq &&
                       band_live(s, q0 + c, kr0 + (e >> 1) * 8)))
          p = 0.f;
        sc[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dt[c]) * s.scale;
      }

    // dV += P^T dO and dK += dS^T Q (P^T and dS^T rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, sc, kk);
      mma_rows<D, LD>(adv, a, dot, kk, lane);
      pack_a(a, dp, kk);
      mma_rows<D, LD>(adk, a, qt, kk, lane);
    }
    __syncthreads();  // the next iteration refills this stage
  }
  store_rows<D>(dk + kv_off, kv_stride, adk, kr0, s.sk, tig);
  store_rows<D>(dv + kv_off, kv_stride, adv, kr0, s.sk, tig);
}

// ---------------------------------------------------------------- f32
using flash_f32::kDPer;
using flash_f32::kQS;
using flash_f32::kSS;
using flash_f32::load_rows;

constexpr size_t kDqSmemF32 =
    sizeof(float) * (4 * static_cast<size_t>(kBQ) * kQS + kBQ * kSS);
constexpr size_t kDkvSmemF32 =
    sizeof(float) *
    (4 * static_cast<size_t>(kBQ) * kQS + 2 * kBQ * kSS + 2 * kBQ);

__global__ void __launch_bounds__(flash_f32::kThreads)
    bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq, Dims s, int d) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (s.h / s.hk);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][kQS]
  float* dos = qs + kBQ * kQS;   // [BQ][kQS]
  float* ks = dos + kBQ * kQS;   // [BK][kQS]
  float* vs = ks + kBK * kQS;    // [BK][kQS]
  float* ps = vs + kBK * kQS;    // [BQ][kSS]: dS

  const size_t row = static_cast<size_t>(s.h) * d;
  const size_t q_off = (static_cast<size_t>(b) * s.sq * s.h + head) * d;
  const size_t kv_off = (static_cast<size_t>(b) * s.sk * s.hk + kvh) * d;
  const size_t kv_row = static_cast<size_t>(s.hk) * d;
  load_rows(q + q_off, qs, kQS, row, q0, s.sq, d);
  load_rows(dout + q_off, dos, kQS, row, q0, s.sq, d);
  const size_t lrow = (static_cast<size_t>(b) * s.h + head) * s.sq;
  float lr[flash_f32::kRows], dl[flash_f32::kRows];
  float acc[flash_f32::kRows][kDPer];
#pragma unroll
  for (int i = 0; i < flash_f32::kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    lr[i] = r < s.sq ? lse[lrow + r] : 0.f;
    dl[i] = r < s.sq ? delta[lrow + r] : 0.f;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;
  }
  const int nd = d / 16;
  int lo, hi;
  key_range(s, q0, &lo, &hi);

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    load_rows(k + kv_off, ks, kQS, kv_row, k0, hi, d);
    load_rows(v + kv_off, vs, kQS, kv_row, k0, hi, d);
    __syncthreads();
    float sc[flash_f32::kRows][flash_f32::kCols] = {};
    float dp[flash_f32::kRows][flash_f32::kCols] = {};
    for (int c = 0; c < d; ++c) {
      float qv[flash_f32::kRows], dv[flash_f32::kRows];
      float kv[flash_f32::kCols], vv[flash_f32::kCols];
#pragma unroll
      for (int i = 0; i < flash_f32::kRows; ++i) {
        qv[i] = qs[(ty + 16 * i) * kQS + c];
        dv[i] = dos[(ty + 16 * i) * kQS + c];
      }
#pragma unroll
      for (int j = 0; j < flash_f32::kCols; ++j) {
        kv[j] = ks[(tx + 16 * j) * kQS + c];
        vv[j] = vs[(tx + 16 * j) * kQS + c];
      }
#pragma unroll
      for (int i = 0; i < flash_f32::kRows; ++i)
#pragma unroll
        for (int j = 0; j < flash_f32::kCols; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < flash_f32::kRows; ++i)
#pragma unroll
      for (int j = 0; j < flash_f32::kCols; ++j) {
        const bool live = band_live(s, q0 + ty + 16 * i, k0 + tx + 16 * j);
        const float p = live ? expf(sc[i][j] * s.scale - lr[i]) : 0.f;
        ps[(ty + 16 * i) * kSS + tx + 16 * j] = p * (dp[i][j] - dl[i]) *
                                               s.scale;
      }
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      float dsv[flash_f32::kRows];
#pragma unroll
      for (int i = 0; i < flash_f32::kRows; ++i)
        dsv[i] = ps[(ty + 16 * i) * kSS + c];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        if (j < nd) {
          const float kk = ks[c * kQS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < flash_f32::kRows; ++i)
            acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, ps
  }
#pragma unroll
  for (int i = 0; i < flash_f32::kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.sq) continue;
    float* dst = dq + q_off + static_cast<size_t>(r) * row;
#pragma unroll
    for (int j = 0; j < kDPer; ++j)
      if (j < nd) dst[tx + 16 * j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(flash_f32::kThreads)
    bwd_dkv_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, Dims s,
                       int d) {
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = s.h / s.hk;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* ks = smem;              // [BK][kQS]
  float* vs = ks + kBK * kQS;    // [BK][kQS]
  float* qs = vs + kBK * kQS;    // [BQ][kQS]
  float* dos = qs + kBQ * kQS;   // [BQ][kQS]
  float* pt = dos + kBQ * kQS;   // [BK][kSS]: P^T
  float* dst = pt + kBK * kSS;   // [BK][kSS]: dS^T
  float* ls = dst + kBK * kSS;   // [BQ]
  float* dls = ls + kBQ;         // [BQ]

  const size_t row = static_cast<size_t>(s.h) * d;
  const size_t kv_row = static_cast<size_t>(s.hk) * d;
  const size_t kv_off = (static_cast<size_t>(b) * s.sk * s.hk + kvh) * d;
  load_rows(k + kv_off, ks, kQS, kv_row, k0, s.sk, d);
  load_rows(v + kv_off, vs, kQS, kv_row, k0, s.sk, d);
  float ak[flash_f32::kRows][kDPer], av[flash_f32::kRows][kDPer];
#pragma unroll
  for (int i = 0; i < flash_f32::kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDPer; ++j) ak[i][j] = av[i][j] = 0.f;
  const int nd = d / 16;
  int lo, hi;
  query_range(s, k0, &lo, &hi);

  for (int j0 = 0; j0 < grp; ++j0) {
    const int head = kvh * grp + j0;
    const size_t q_off = (static_cast<size_t>(b) * s.sq * s.h + head) * d;
    const size_t lrow = (static_cast<size_t>(b) * s.h + head) * s.sq;
    for (int q0 = lo; q0 < hi; q0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      load_rows(q + q_off, qs, kQS, row, q0, s.sq, d);
      load_rows(dout + q_off, dos, kQS, row, q0, s.sq, d);
      for (int i = threadIdx.x; i < kBQ; i += blockDim.x) {
        const bool ok = q0 + i < s.sq;
        ls[i] = ok ? lse[lrow + q0 + i] : 0.f;
        dls[i] = ok ? delta[lrow + q0 + i] : 0.f;
      }
      __syncthreads();
      // rows: keys ty + 16 i; columns: queries tx + 16 j
      float sc[flash_f32::kRows][flash_f32::kCols] = {};
      float dp[flash_f32::kRows][flash_f32::kCols] = {};
      for (int c = 0; c < d; ++c) {
        float kv[flash_f32::kRows], vv[flash_f32::kRows];
        float qv[flash_f32::kCols], gv[flash_f32::kCols];
#pragma unroll
        for (int i = 0; i < flash_f32::kRows; ++i) {
          kv[i] = ks[(ty + 16 * i) * kQS + c];
          vv[i] = vs[(ty + 16 * i) * kQS + c];
        }
#pragma unroll
        for (int j = 0; j < flash_f32::kCols; ++j) {
          qv[j] = qs[(tx + 16 * j) * kQS + c];
          gv[j] = dos[(tx + 16 * j) * kQS + c];
        }
#pragma unroll
        for (int i = 0; i < flash_f32::kRows; ++i)
#pragma unroll
          for (int j = 0; j < flash_f32::kCols; ++j) {
            sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < flash_f32::kRows; ++i)
#pragma unroll
        for (int j = 0; j < flash_f32::kCols; ++j) {
          const int qc = tx + 16 * j;
          const bool live = q0 + qc < s.sq &&
                            band_live(s, q0 + qc, k0 + ty + 16 * i);
          const float p = live ? expf(sc[i][j] * s.scale - ls[qc]) : 0.f;
          pt[(ty + 16 * i) * kSS + qc] = p;
          dst[(ty + 16 * i) * kSS + qc] = p * (dp[i][j] - dls[qc]) * s.scale;
        }
      __syncthreads();
      for (int c = 0; c < kBQ; ++c) {
        float pv[flash_f32::kRows], dsv[flash_f32::kRows];
#pragma unroll
        for (int i = 0; i < flash_f32::kRows; ++i) {
          pv[i] = pt[(ty + 16 * i) * kSS + c];
          dsv[i] = dst[(ty + 16 * i) * kSS + c];
        }
#pragma unroll
        for (int j = 0; j < kDPer; ++j) {
          if (j < nd) {
            const float gq = dos[c * kQS + tx + 16 * j];
            const float qq = qs[c * kQS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < flash_f32::kRows; ++i) {
              av[i][j] = fmaf(pv[i], gq, av[i][j]);
              ak[i][j] = fmaf(dsv[i], qq, ak[i][j]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < flash_f32::kRows; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= s.sk) continue;
    const size_t o = kv_off + static_cast<size_t>(key) * kv_row;
#pragma unroll
    for (int j = 0; j < kDPer; ++j)
      if (j < nd) {
        dk[o + tx + 16 * j] = ak[i][j];
        dv[o + tx + 16 * j] = av[i][j];
      }
  }
}

// ------------------------------------------------------------- launch
bool valid(int sk, int h, int hk, int d, int causal, int window) {
  return sk >= 0 && hk > 0 && h % hk == 0 && (d == 64 || d == 128) &&
         window >= 0 && (window == 0 || causal);
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, const Dims& s, dim3 grid, cudaStream_t st) {
  static bool configured = false;
  constexpr size_t bytes = dq_smem_bytes<D>();
  if (int e = set_smem(bwd_dq_bf16_kernel<D>, bytes, &configured)) return e;
  bwd_dq_bf16_kernel<D><<<grid, kThreadsTC, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), s);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, const Dims& s, dim3 grid,
                    cudaStream_t st) {
  static bool configured = false;
  constexpr size_t bytes = dkv_smem_bytes<D>();
  if (int e = set_smem(bwd_dkv_bf16_kernel<D>, bytes, &configured)) return e;
  bwd_dkv_bf16_kernel<D><<<grid, kThreadsTC, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, do, dq (B, Sq, H, D); k, v (B, Sk, HK, D); lse, delta (B, H, Sq) f32;
// all contiguous, one dtype for the (B, S, *, D) tensors. D is 64 or 128;
// window 0 means none (needs causal).
extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int sq, int sk,
    int h, int hk, int d, int causal, int window, float sm_scale, int dtype,
    void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  if (!valid(sk, h, hk, d, causal, window) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims s{sq, sk, h, hk, causal, window, sk - sq, sm_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  if (dtype == kBF16)
    return d == 64
               ? launch_dq_bf16<64>(q, k, v, dout, l, dl, dq, s, grid, st)
               : launch_dq_bf16<128>(q, k, v, dout, l, dl, dq, s, grid, st);
  if (dtype == kF32) {
    static bool configured = false;
    if (int e = set_smem(bwd_dq_f32_kernel, kDqSmemF32, &configured))
      return e;
    bwd_dq_f32_kernel<<<grid, flash_f32::kThreads, kDqSmemF32, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dq), s, d);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above; writes dk, dv (B, Sk, HK, D), each KV head's sum over the
// query heads of its group.
extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int sq,
    int sk, int h, int hk, int d, int causal, int window, float sm_scale,
    int dtype, void* stream) {
  if (b <= 0 || sk <= 0) return 0;
  if (sq < 0 || !valid(sk, h, hk, d, causal, window) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dk) ||
      !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims s{sq, sk, h, hk, causal, window, sk - sq, sm_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const dim3 grid((sk + kBK - 1) / kBK, hk, b);
  if (dtype == kBF16)
    return d == 64 ? launch_dkv_bf16<64>(q, k, v, dout, l, dl, dk, dv, s,
                                         grid, st)
                   : launch_dkv_bf16<128>(q, k, v, dout, l, dl, dk, dv, s,
                                          grid, st);
  if (dtype == kF32) {
    static bool configured = false;
    if (int e = set_smem(bwd_dkv_f32_kernel, kDkvSmemF32, &configured))
      return e;
    bwd_dkv_f32_kernel<<<grid, flash_f32::kThreads, kDkvSmemF32, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), s, d);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
