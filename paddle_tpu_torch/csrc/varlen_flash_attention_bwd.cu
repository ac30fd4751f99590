// Varlen (packed) flash attention backward for Hopper: K8a (dq) and K8b
// (dk, dv).
//
// Replaces: paddle_tpu/ops/pallas/varlen_flash_attention.py, `_varlen_bwd`
// -> `_bwd_dq_kernel` (K8a) and `_bwd_dkv_kernel` (K8b). Sequences are
// packed back to back, q / do / dq (Tq, H, D) and k / v / dk / dv (Tk, HK,
// D), with cu_seqlens prefix sums; lse and delta = rowsum(dO * O) are (H,
// Tq) f32 (the forward K3 writes lse; the wrapper computes delta). Both
// kernels recompute the probabilities from lse, P = exp(S * scale - lse):
//   dS = P * (dO V^T - delta) * scale
//   dQ = dS K            dK = dS^T Q            dV = P^T dO
// with the TPU kernel's roundings: P is rounded to dO's dtype before dV,
// dS to K's dtype before dQ and to Q's dtype before dK, every product
// accumulates in f32, and dq, dk, dv are written in the input dtype. The
// live pairs are K3's (varlen_seg.cuh): one segment, bottom-right causal
// per segment, the per-segment window. A masked pair's probability is
// taken to 0 by a select before it is used (a row with no live key has
// lse ~ -1e30 and exp(s - lse) overflows there), so such rows and padding
// rows past cu_seqlens_q[-1] get dq = 0, and a key no query sees gets dk =
// dv = 0.
//
// Bound on the H100: operations at training shapes. Per live pair K8a does
// 3 products of D (S, dP, dQ: 6 * D flops) and K8b 4 (S, dP, dV, dK: 8 * D
// flops). At the packed 941M configuration (T = 4,096 in 8 segments of
// 1,600 .. 76 tokens, 32 heads, D = 64, causal) that is 61.99 M live pairs
// over 32 heads: K8a ~23.8 GFLOP (~0.024 ms at 989 TFLOP/s, about the time
// its ~85 MB of q, k, v, do, dq, lse and delta take at 3.35 TB/s) and K8b
// ~31.7 GFLOP (~0.032 ms).
//
// Design: K7's (flash_attention_bwd.cu) with the segment masks in place of
// the dense band. The TPU grid carries dq (or dk/dv) in scratch across its
// sequential key (or query) axis; here each CTA owns one 64-row tile of the
// output and loops over the tiles of the other side inside the block.
// - K8a: grid (H, query tiles). Q and dO stay in shared memory. The CTA
//   walks only the key range its rows can see (varlen_seg.cuh key_range)
//   and, per 64-key tile, first tests whether any pair is live (from
//   positions or indices, varlen_seg.cuh Walk), skipping a dead tile
//   before loading any K/V byte; a tile whose pairs are all live skips the
//   per-pair mask.
// - K8b: grid (HK, key tiles). One CTA serves a KV head for all G query
//   heads of its group: it walks the query range that sees its keys
//   (varlen_seg.cuh query_range, the transpose of key_range) as a sequence
//   of (live query tile, head) pairs, the heads fastest, summing dk and dv
//   in f32 registers: no K/V repeated per query head (the TPU kernel
//   materialises `jnp.repeat`ed K/V and sums the group afterwards) and no
//   atomics, so the result is deterministic. Q, dO, lse and delta stream
//   through a two-stage cp.async ring: the next pair's copy is in flight
//   while this pair's four products run. The test of which query tile
//   comes next runs ahead of its copy, so a dead tile's Q / dO bytes are
//   never read: for a key tile inside one segment (the common case) from
//   positions alone, else from the query indices written into a second set
//   of index arrays (varlen_seg.cuh Walk, shared with K3 and K8a). The
//   B operands of K Q^T and V dO^T come from ldmatrix.x4, those of P^T dO
//   and dS^T Q from ldmatrix.trans. Each pair runs in two halves of 32
//   queries, so only one half's score and dP accumulators are live (three
//   CTAs per SM at D = 64); each warp's K and V A fragments stay in
//   registers for the whole walk, and P's exp2 is one MUFU instruction
//   (exp2_ftz).
// - Heaviest tiles first: a one-CTA kernel (varlen_seg.cuh) ranks the
//   tiles by the length of the range each walks (longest first) before the
//   main launch, and blockIdx.y walks that order with the heads fastest, so
//   the longest tiles of long segments do not trail at the end of the grid.
// - bf16: tensor cores through `mma.sync` m16n8k16 in K7's layout and with
//   flash_mma.cuh's fragment helpers: each of the 4 warps owns 16 output
//   rows; the score and dP accumulators (16 x 64 per warp, 16 x 32 per
//   half in K8b) become dS / P in place and are re-packed as the A operand
//   of the next product.
// - f32: CUDA-core FMA in the tile shape of flash_f32.cuh (256 threads,
//   each a 4 x 4 micro-tile of scores and a 4 x D/16 slice of the output).
// K8a keeps one stage of shared K / V tiles, loaded after each tile's
// index test.
#include "common.cuh"
#include "flash_f32.cuh"
#include "flash_mma.cuh"
#include "varlen_seg.cuh"

using namespace ptt;
using namespace ptt::varlen;

namespace {

namespace fl = ptt::flash;
using bf16 = __nv_bfloat16;
using fl::a_frag;
using fl::b_frags;
using fl::cp_async4;
using fl::cp_async_commit;
using fl::cp_async_wait;
using fl::exp2_ftz;
using fl::kLog2e;
using fl::kThreadsTC;
using fl::lds32;
using fl::load_tile;
using fl::mma_bf16;
using fl::mma_rows;
using fl::pack_a;
using fl::set_smem;
using fl::store_rows;

static_assert(fl::kBQ == kTile && fl::kBK == kTile &&
                  flash_f32::kBQ == kTile && flash_f32::kBK == kTile,
              "K8 shares the 64-row tiles of flash_mma.cuh, flash_f32.cuh "
              "and varlen_seg.cuh");

// ------------------------------------------------------------ K8a bf16
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 4ull * kTile * (D + 8) + sizeof(int) * 4 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 2)
    varlen_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ cu_q,
                              const int* __restrict__ cu_k,
                              const int* __restrict__ order,
                              bf16* __restrict__ dq, Seg s) {
  constexpr int LD = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kNtS = kTile / 8;
  constexpr int kNtO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTile * LD;
  bf16* ks = dos + kTile * LD;
  bf16* vs = ks + kTile * LD;
  int* qseg = reinterpret_cast<int*>(vs + kTile * LD);
  int* qrel = qseg + kTile;
  int* kseg = qrel + kTile;
  int* krel = kseg + kTile;
  __shared__ int krange[2];

  const int head = blockIdx.x;
  const int q0 = order[blockIdx.y] * kTile;
  const int kvh = head / (s.h / s.hk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t q_stride = static_cast<size_t>(s.h) * D;
  const size_t kv_stride = static_cast<size_t>(s.hk) * D;
  const bf16* kb = k + static_cast<size_t>(kvh) * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * D;

  query_rows(cu_q, cu_k, s.nseg, s.tq, q0, qseg, qrel);
  load_tile<D, LD>(qs, q + static_cast<size_t>(head) * D, q_stride, q0,
                   s.tq);
  load_tile<D, LD>(dos, dout + static_cast<size_t>(head) * D, q_stride, q0,
                   s.tq);
  cp_async_commit();
  __syncthreads();
  if (threadIdx.x == 0)
    key_range(cu_k, s.tq, s.tk, q0, qseg, qrel, s.causal, s.window, krange);
  __syncthreads();
  const int lo = krange[0];
  const int hi = krange[1];

  const int lr = warp * 16 + g;  // the thread's rows lr, lr + 8 of the tile
  int rseg[2], rrel[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = lr + half * 8;
    const size_t at = static_cast<size_t>(head) * s.tq + q0 + r;
    const bool ok = q0 + r < s.tq;
    rseg[half] = qseg[r];
    rrel[half] = qrel[r];
    lse2[half] = ok ? lse[at] * kLog2e : 0.f;
    dl[half] = ok ? delta[at] : 0.f;
  }
  float acc[kNtO][4];
#pragma unroll
  for (int i = 0; i < kNtO; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float scale_log2 = s.scale * kLog2e;
  const bf16* qw = qs + lr * LD + tig * 2;
  const bf16* dw = dos + lr * LD + tig * 2;
  const Walk walk = key_walk(cu_k, qseg, qrel, hi, s.causal, s.window);

  // dead tiles are passed over before any K/V byte is read
  int k0 = lo;
  for (int state; (state = next_key_tile(cu_k, s.nseg, walk, &k0, hi, qseg,
                                         qrel, kseg, krel)) != kDead;
       k0 += kTile) {
    load_tile<D, LD>(ks, kb, kv_stride, k0, hi);
    load_tile<D, LD>(vs, vb, kv_stride, k0, hi);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

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
        const bf16* kr = ks + (nt * 8 + g) * LD + tig * 2 + kk * 16;
        const bf16* vr = vs + (nt * 8 + g) * LD + tig * 2 + kk * 16;
        mma_bf16(sc[nt], aq, lds32(kr), lds32(kr + 8));
        mma_bf16(dp[nt], ad, lds32(vr), lds32(vr + 8));
      }
    }

    // P from lse (dead pairs 0 by a select), then dS = P (dP - delta)
    // scale in sc
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int c = nt * 8 + tig * 2 + (e & 1);
        const bool live = state == kFull ||
                          walk.live(rseg[half], rrel[half], kseg, krel, k0, c);
        const float p =
            live ? exp2f(fmaf(sc[nt][e], scale_log2, -lse2[half])) : 0.f;
        sc[nt][e] = p * (dp[nt][e] - dl[half]) * s.scale;
      }

    // dQ += dS K (dS rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, sc, kk);
      mma_rows<D, LD>(acc, a, ks, kk, lane);
    }
    __syncthreads();  // the next tile overwrites K, V and the key indices
  }
  cp_async_wait<0>();
  store_rows<D>(dq + static_cast<size_t>(head) * D, q_stride, acc, q0 + lr,
                s.tq, tig);
}

// ------------------------------------------------------------ K8b bf16
// Shared memory: the K and V tiles, two stages of Q and dO tiles and of
// their lse and delta rows, two sets of query indices, the key indices.
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * 6ull * kTile * (D + 8) +
         sizeof(float) * 4 * kTile + sizeof(int) * 6 * kTile;
}

// Q, dO, lse and delta of query tile q0, query head `head`, into one stage
// (rows at or past tq zero-filled; one cp.async group with the caller's
// commit).
template <int D>
__device__ __forceinline__ void load_query_stage(
    bf16* qs, bf16* dos, float* ls, float* dls, const bf16* __restrict__ q,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int q0, int head, const Seg& s) {
  constexpr int LD = D + 8;
  const size_t q_stride = static_cast<size_t>(s.h) * D;
  load_tile<D, LD>(qs, q + static_cast<size_t>(head) * D, q_stride, q0, s.tq);
  load_tile<D, LD>(dos, dout + static_cast<size_t>(head) * D, q_stride, q0,
                   s.tq);
  for (int i = threadIdx.x; i < kTile; i += kThreadsTC) {
    const bool ok = q0 + i < s.tq;
    const size_t at = ok ? static_cast<size_t>(head) * s.tq + q0 + i : 0;
    cp_async4(ls + i, lse + at, ok);
    cp_async4(dls + i, delta + at, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, D == 64 ? 3 : 2)
    varlen_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ cu_q,
                               const int* __restrict__ cu_k,
                               const int* __restrict__ order,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               Seg s) {
  constexpr int LD = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kNtH = kTile / 16;  // score n-tiles (queries) per half
  constexpr int kNtO = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile * LD;
  bf16* qs = vs + kTile * LD;       // [2][kTile][LD]
  bf16* dos = qs + 2 * kTile * LD;  // [2][kTile][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * kTile * LD);  // [2][kTile]
  float* dls = ls + 2 * kTile;                                 // [2][kTile]
  int* qseg = reinterpret_cast<int*>(dls + 2 * kTile);         // [2][kTile]
  int* qrel = qseg + 2 * kTile;                                // [2][kTile]
  int* kseg = qrel + 2 * kTile;
  int* krel = kseg + kTile;
  __shared__ int qrange[2];

  const int kvh = blockIdx.x;
  const int k0 = order[blockIdx.y] * kTile;
  const int grp = s.h / s.hk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t kv_stride = static_cast<size_t>(s.hk) * D;
  const size_t kv_off = static_cast<size_t>(kvh) * D;
  // keys at or past cu_k[nseg] are padding: no query sees them
  const int kend = min(s.tk, cu_k[s.nseg]);

  key_rows(cu_k, s.nseg, k0, kend, kseg, krel);
  load_tile<D, LD>(ks, k + kv_off, kv_stride, k0, kend);
  load_tile<D, LD>(vs, v + kv_off, kv_stride, k0, kend);
  __syncthreads();
  if (threadIdx.x == 0)
    query_range(cu_q, cu_k, kseg, krel, s.causal, s.window, qrange);
  __syncthreads();
  const int hi = qrange[1];

  // The CTA walks the pairs (live query tile, head of the group), the heads
  // fastest; the copy of the next pair's Q, dO, lse and delta is in flight
  // while this pair's four products run (two stages), and the next live
  // tile's index test (into the other set of query indices) runs ahead of
  // its copy, so no Q / dO byte of a dead tile is read.
  const Walk walk =
      query_walk(cu_q, cu_k, s.tq, kseg, krel, s.causal, s.window);
  // from the query tile at *qp on, the first live one: its state (kDead
  // when none is left); tiles tested by index write their query indices
  // into set `buf`
  auto next_tile = [&](int* qp, int buf) -> int {
    return next_query_tile(cu_q, cu_k, s.nseg, s.tq, walk, qp, hi,
                           qseg + buf * kTile, qrel + buf * kTile, kseg,
                           krel);
  };
  int q0 = qrange[0];
  int state = next_tile(&q0, 0);
  if (state != kDead)
    load_query_stage<D>(qs, dos, ls, dls, q, dout, lse, delta, q0,
                        kvh * grp, s);
  cp_async_commit();

  const int lk = warp * 16 + g;  // the thread's keys lk, lk + 8 of the tile
  const int kseg_r[2] = {kseg[lk], kseg[lk + 8]};
  const int krel_r[2] = {krel[lk], krel[lk + 8]};
  float adk[kNtO][4], adv[kNtO][4];
#pragma unroll
  for (int i = 0; i < kNtO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;
  const float scale_log2 = s.scale * kLog2e;
  const bf16* kw = ks + lk * LD + tig * 2;
  const bf16* vw = vs + lk * LD + tig * 2;
  int j = 0, stage = 0, buf = 0;
  // the warp's K and V A fragments, constant over the CTA's walk
  uint32_t akr[kSteps][4], avr[kSteps][4];
  bool first = true;

  while (state != kDead) {
    int nq0 = q0, nj = j + 1, nstate = state, nbuf = buf;
    if (nj == grp) {
      nj = 0;
      nq0 = q0 + kTile;
      nbuf = buf ^ 1;
      nstate = next_tile(&nq0, nbuf);
    }
    const int nst = stage ^ 1;
    if (nstate != kDead) {
      load_query_stage<D>(qs + nst * kTile * LD, dos + nst * kTile * LD,
                          ls + nst * kTile, dls + nst * kTile, q, dout, lse,
                          delta, nq0, kvh * grp + nj, s);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        a_frag<LD>(akr[kk], kw, kk);
        a_frag<LD>(avr[kk], vw, kk);
      }
      first = false;
    }
    const bf16* qt = qs + stage * kTile * LD;
    const bf16* dt = dos + stage * kTile * LD;
    const float* lt = ls + stage * kTile;
    const float* dlt = dls + stage * kTile;
    const int* qsg = qseg + buf * kTile;
    const int* qrl = qrel + buf * kTile;

    // the tile's 64 queries in two halves of 32, so the score and dP
    // accumulators of only one half are live at a time
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 32 queries
      float sc[kNtH][4], dp[kNtH][4];
#pragma unroll
      for (int nt = 0; nt < kNtH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t* ak = akr[kk];
        const uint32_t* av = avr[kk];
#pragma unroll
        for (int nt = 0; nt < kNtH; nt += 2) {
          uint32_t bq[4], bd[4];
          b_frags<LD>(bq, qt, hq * kNtH + nt, kk, lane);
          b_frags<LD>(bd, dt, hq * kNtH + nt, kk, lane);
          mma_bf16(sc[nt], ak, bq[0], bq[1]);
          mma_bf16(sc[nt + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[nt], av, bd[0], bd[1]);
          mma_bf16(dp[nt + 1], av, bd[2], bd[3]);
        }
      }

      // P^T in sc (dead pairs 0 by a select), dS^T = P^T (dP^T - delta)
      // scale in dp
#pragma unroll
      for (int nt = 0; nt < kNtH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the query in the tile
          const int c = (hq * kNtH + nt) * 8 + tig * 2 + (e & 1);
          const int half = e >> 1;
          const bool live =
              state == kFull ||
              walk.live(kseg_r[half], krel_r[half], qsg, qrl, q0, c);
          const float p =
              live ? exp2_ftz(fmaf(sc[nt][e], scale_log2, -lt[c] * kLog2e))
                   : 0.f;
          sc[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dlt[c]) * s.scale;
        }

      // dV += P^T dO and dK += dS^T Q over the half's queries (P^T and
      // dS^T rounded to bf16)
#pragma unroll
      for (int kk = 0; kk < kNtH / 2; ++kk) {
        uint32_t a[4];
        pack_a(a, sc, kk);
        mma_rows<D, LD>(adv, a, dt, hq * (kNtH / 2) + kk, lane);
        pack_a(a, dp, kk);
        mma_rows<D, LD>(adk, a, qt, hq * (kNtH / 2) + kk, lane);
      }
    }
    __syncthreads();  // the next iterations refill this stage and indices
    q0 = nq0;
    j = nj;
    state = nstate;
    buf = nbuf;
    stage = nst;
  }
  cp_async_wait<0>();
  store_rows<D>(dk + kv_off, kv_stride, adk, k0 + lk, s.tk, tig);
  store_rows<D>(dv + kv_off, kv_stride, adv, k0 + lk, s.tk, tig);
}

// ---------------------------------------------------------------- f32
using flash_f32::kCols;
using flash_f32::kDPer;
using flash_f32::kQS;
using flash_f32::kRows;
using flash_f32::kSS;
using flash_f32::load_rows;

constexpr size_t kDqSmemF32 =
    sizeof(float) * (4 * static_cast<size_t>(kTile) * kQS + kTile * kSS) +
    sizeof(int) * 4 * kTile;
constexpr size_t kDkvSmemF32 =
    sizeof(float) * (4 * static_cast<size_t>(kTile) * kQS +
                     2 * kTile * kSS + 2 * kTile) +
    sizeof(int) * 4 * kTile;

__global__ void __launch_bounds__(flash_f32::kThreads)
    varlen_bwd_dq_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ cu_q,
                             const int* __restrict__ cu_k,
                             const int* __restrict__ order,
                             float* __restrict__ dq, Seg s, int d) {
  const int head = blockIdx.x;
  const int q0 = order[blockIdx.y] * kTile;
  const int kvh = head / (s.h / s.hk);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* qs = smem;               // [64][kQS]
  float* dos = qs + kTile * kQS;  // [64][kQS]
  float* ks = dos + kTile * kQS;  // [64][kQS]
  float* vs = ks + kTile * kQS;   // [64][kQS]
  float* ps = vs + kTile * kQS;   // [64][kSS]: dS
  int* qseg = reinterpret_cast<int*>(ps + kTile * kSS);
  int* qrel = qseg + kTile;
  int* kseg = qrel + kTile;
  int* krel = kseg + kTile;
  __shared__ int krange[2];

  const size_t row = static_cast<size_t>(s.h) * d;
  const size_t kv_row = static_cast<size_t>(s.hk) * d;
  query_rows(cu_q, cu_k, s.nseg, s.tq, q0, qseg, qrel);
  load_rows(q + static_cast<size_t>(head) * d, qs, kQS, row, q0, s.tq, d);
  load_rows(dout + static_cast<size_t>(head) * d, dos, kQS, row, q0, s.tq,
            d);
  float lr[kRows], dl[kRows], acc[kRows][kDPer];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    const size_t at = static_cast<size_t>(head) * s.tq + r;
    lr[i] = r < s.tq ? lse[at] : 0.f;
    dl[i] = r < s.tq ? delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    key_range(cu_k, s.tq, s.tk, q0, qseg, qrel, s.causal, s.window, krange);
  __syncthreads();
  const int lo = krange[0];
  const int hi = krange[1];
  const int nd = d / 16;

  for (int k0 = lo; k0 < hi; k0 += kTile) {
    key_rows(cu_k, s.nseg, k0, hi, kseg, krel);
    __syncthreads();
    const int state =
        tile_pairs(qseg, qrel, kseg, krel, s.causal, s.window);
    if (state == kDead) continue;
    load_rows(k + static_cast<size_t>(kvh) * d, ks, kQS, kv_row, k0, hi, d);
    load_rows(v + static_cast<size_t>(kvh) * d, vs, kQS, kv_row, k0, hi, d);
    __syncthreads();
    float sc[kRows][kCols] = {};
    float dp[kRows][kCols] = {};
    for (int c = 0; c < d; ++c) {
      float qv[kRows], gv[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = qs[(ty + 16 * i) * kQS + c];
        gv[i] = dos[(ty + 16 * i) * kQS + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = ks[(tx + 16 * j) * kQS + c];
        vv[j] = vs[(tx + 16 * j) * kQS + c];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        const bool live =
            state == kFull || live_pair(qseg[r], qrel[r], kseg[c], krel[c],
                                        s.causal, s.window);
        const float p = live ? expf(sc[i][j] * s.scale - lr[i]) : 0.f;
        ps[r * kSS + c] = p * (dp[i][j] - dl[i]) * s.scale;
      }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = ps[(ty + 16 * i) * kSS + c];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        if (j < nd) {
          const float kk = ks[c * kQS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, ps, the indices
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s.tq) continue;
    float* dst = dq + static_cast<size_t>(head) * d + r * row;
#pragma unroll
    for (int j = 0; j < kDPer; ++j)
      if (j < nd) dst[tx + 16 * j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(flash_f32::kThreads)
    varlen_bwd_dkv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ cu_q,
                              const int* __restrict__ cu_k,
                              const int* __restrict__ order,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Seg s, int d) {
  const int kvh = blockIdx.x;
  const int k0 = order[blockIdx.y] * kTile;
  const int grp = s.h / s.hk;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* ks = smem;               // [64][kQS]
  float* vs = ks + kTile * kQS;   // [64][kQS]
  float* qs = vs + kTile * kQS;   // [64][kQS]
  float* dos = qs + kTile * kQS;  // [64][kQS]
  float* pt = dos + kTile * kQS;  // [64][kSS]: P^T
  float* dst = pt + kTile * kSS;  // [64][kSS]: dS^T
  float* ls = dst + kTile * kSS;  // [64]
  float* dls = ls + kTile;        // [64]
  int* qseg = reinterpret_cast<int*>(dls + kTile);
  int* qrel = qseg + kTile;
  int* kseg = qrel + kTile;
  int* krel = kseg + kTile;
  __shared__ int qrange[2];

  const size_t row = static_cast<size_t>(s.h) * d;
  const size_t kv_row = static_cast<size_t>(s.hk) * d;
  const size_t kv_off = static_cast<size_t>(kvh) * d;
  const int kend = min(s.tk, cu_k[s.nseg]);
  key_rows(cu_k, s.nseg, k0, kend, kseg, krel);
  load_rows(k + kv_off, ks, kQS, kv_row, k0, kend, d);
  load_rows(v + kv_off, vs, kQS, kv_row, k0, kend, d);
  float ak[kRows][kDPer], av[kRows][kDPer];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDPer; ++j) ak[i][j] = av[i][j] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0)
    query_range(cu_q, cu_k, kseg, krel, s.causal, s.window, qrange);
  __syncthreads();
  const int lo = qrange[0];
  const int hi = qrange[1];
  const int nd = d / 16;

  for (int q0 = lo; q0 < hi; q0 += kTile) {
    query_rows(cu_q, cu_k, s.nseg, s.tq, q0, qseg, qrel);
    __syncthreads();
    const int state =
        tile_pairs(qseg, qrel, kseg, krel, s.causal, s.window);
    if (state == kDead) continue;
    for (int j0 = 0; j0 < grp; ++j0) {
      const int head = kvh * grp + j0;
      __syncthreads();  // the previous head's readers are done
      load_rows(q + static_cast<size_t>(head) * d, qs, kQS, row, q0, s.tq,
                d);
      load_rows(dout + static_cast<size_t>(head) * d, dos, kQS, row, q0,
                s.tq, d);
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const bool ok = q0 + i < s.tq;
        const size_t at = static_cast<size_t>(head) * s.tq + q0 + i;
        ls[i] = ok ? lse[at] : 0.f;
        dls[i] = ok ? delta[at] : 0.f;
      }
      __syncthreads();
      // rows: keys ty + 16 i; columns: queries tx + 16 j
      float sc[kRows][kCols] = {};
      float dp[kRows][kCols] = {};
      for (int c = 0; c < d; ++c) {
        float kv[kRows], vv[kRows], qv[kCols], gv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = ks[(ty + 16 * i) * kQS + c];
          vv[i] = vs[(ty + 16 * i) * kQS + c];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qv[j] = qs[(tx + 16 * j) * kQS + c];
          gv[j] = dos[(tx + 16 * j) * kQS + c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int kr = ty + 16 * i;
          const int qc = tx + 16 * j;
          const bool live =
              state == kFull || live_pair(qseg[qc], qrel[qc], kseg[kr],
                                          krel[kr], s.causal, s.window);
          const float p = live ? expf(sc[i][j] * s.scale - ls[qc]) : 0.f;
          pt[kr * kSS + qc] = p;
          dst[kr * kSS + qc] = p * (dp[i][j] - dls[qc]) * s.scale;
        }
      __syncthreads();
      for (int c = 0; c < kTile; ++c) {
        float pv[kRows], dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = pt[(ty + 16 * i) * kSS + c];
          dsv[i] = dst[(ty + 16 * i) * kSS + c];
        }
#pragma unroll
        for (int j = 0; j < kDPer; ++j) {
          if (j < nd) {
            const float gq = dos[c * kQS + tx + 16 * j];
            const float qq = qs[c * kQS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              av[i][j] = fmaf(pv[i], gq, av[i][j]);
              ak[i][j] = fmaf(dsv[i], qq, ak[i][j]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= s.tk) continue;
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
bool valid(int nseg, int h, int hk, int d, int causal, int window) {
  return nseg > 0 && hk > 0 && h % hk == 0 && (d == 64 || d == 128) &&
         window >= 0 && (window == 0 || causal);
}

}  // namespace

// q, do, dq (Tq, H, D); k, v (Tk, HK, D); lse, delta (H, Tq) f32; cu_q,
// cu_k (nseg + 1,) int32; order int32 scratch of ceil(Tq / 64); all
// contiguous, one dtype for the (T, *, D) tensors. D is 64 or 128; window
// 0 means none (needs causal).
extern "C" int ptt_varlen_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cu_q, const void* cu_k,
    void* order, void* dq, int tq, int tk, int nseg, int h, int hk, int d,
    int causal, int window, float sm_scale, int dtype, void* stream) {
  if (tq <= 0) return 0;
  const int ntiles = (tq + kTile - 1) / kTile;
  if (tk < 0 || ntiles > 65535 || !valid(nseg, h, hk, d, causal, window) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seg s{tq, tk, nseg, h, hk, causal, window, sm_scale};
  const int* cq = static_cast<const int*>(cu_q);
  const int* ck = static_cast<const int*>(cu_k);
  int* ord = static_cast<int*>(order);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (int e = launch_tile_order(cq, ck, s, 0, ntiles, ord, st)) return e;
  const dim3 grid(h, ntiles);
  if (dtype == kBF16) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    const bf16* db = static_cast<const bf16*>(dout);
    bf16* out = static_cast<bf16*>(dq);
    if (d == 64) {
      static bool configured = false;
      constexpr size_t bytes = dq_smem_bytes<64>();
      if (int e = set_smem(varlen_bwd_dq_bf16_kernel<64>, bytes, &configured))
        return e;
      varlen_bwd_dq_bf16_kernel<64><<<grid, kThreadsTC, bytes, st>>>(
          qb, kb, vb, db, l, dl, cq, ck, ord, out, s);
    } else {
      static bool configured = false;
      constexpr size_t bytes = dq_smem_bytes<128>();
      if (int e = set_smem(varlen_bwd_dq_bf16_kernel<128>, bytes, &configured))
        return e;
      varlen_bwd_dq_bf16_kernel<128><<<grid, kThreadsTC, bytes, st>>>(
          qb, kb, vb, db, l, dl, cq, ck, ord, out, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == kF32) {
    static bool configured = false;
    if (int e = set_smem(varlen_bwd_dq_f32_kernel, kDqSmemF32, &configured))
      return e;
    varlen_bwd_dq_f32_kernel<<<grid, flash_f32::kThreads, kDqSmemF32, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        cq, ck, ord, static_cast<float*>(dq), s, d);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above; writes dk, dv (Tk, HK, D), each KV head's sum over the query
// heads of its group; order is int32 scratch of ceil(Tk / 64).
extern "C" int ptt_varlen_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cu_q, const void* cu_k,
    void* order, void* dk, void* dv, int tq, int tk, int nseg, int h, int hk,
    int d, int causal, int window, float sm_scale, int dtype, void* stream) {
  if (tk <= 0) return 0;
  const int ntiles = (tk + kTile - 1) / kTile;
  if (tq < 0 || ntiles > 65535 || !valid(nseg, h, hk, d, causal, window) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dk) || !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seg s{tq, tk, nseg, h, hk, causal, window, sm_scale};
  const int* cq = static_cast<const int*>(cu_q);
  const int* ck = static_cast<const int*>(cu_k);
  int* ord = static_cast<int*>(order);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (int e = launch_tile_order(cq, ck, s, 1, ntiles, ord, st)) return e;
  const dim3 grid(hk, ntiles);
  if (dtype == kBF16) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    const bf16* db = static_cast<const bf16*>(dout);
    bf16* gk = static_cast<bf16*>(dk);
    bf16* gv = static_cast<bf16*>(dv);
    if (d == 64) {
      static bool configured = false;
      constexpr size_t bytes = dkv_smem_bytes<64>();
      if (int e = set_smem(varlen_bwd_dkv_bf16_kernel<64>, bytes, &configured))
        return e;
      varlen_bwd_dkv_bf16_kernel<64><<<grid, kThreadsTC, bytes, st>>>(
          qb, kb, vb, db, l, dl, cq, ck, ord, gk, gv, s);
    } else {
      static bool configured = false;
      constexpr size_t bytes = dkv_smem_bytes<128>();
      if (int e = set_smem(varlen_bwd_dkv_bf16_kernel<128>, bytes, &configured))
        return e;
      varlen_bwd_dkv_bf16_kernel<128><<<grid, kThreadsTC, bytes, st>>>(
          qb, kb, vb, db, l, dl, cq, ck, ord, gk, gv, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == kF32) {
    static bool configured = false;
    if (int e =
            set_smem(varlen_bwd_dkv_f32_kernel, kDkvSmemF32, &configured))
      return e;
    varlen_bwd_dkv_f32_kernel<<<grid, flash_f32::kThreads, kDkvSmemF32, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        cq, ck, ord, static_cast<float*>(dk), static_cast<float*>(dv), s, d);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
