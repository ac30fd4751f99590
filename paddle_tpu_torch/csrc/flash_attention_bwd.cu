// Flash attention backward for Hopper: K7, one fused kernel for dq, dk and
// dv, in bf16 or fp16 on wgmma and in f32 on the tensor cores as 3xTF32.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py, `_flash_bwd` ->
// `_bwd_dq_kernel` (its pl.pallas_call at :402) and `_bwd_dkv_kernel`
// (:425). Both recompute the probabilities from the forward's
// log-sum-exp, P = exp(S * scale - lse), and take delta = rowsum(dO * O)
// (f32, computed by the wrapper):
//   dS = P * (dO V^T - delta) * scale
//   dQ = dS K            dK = dS^T Q            dV = P^T dO
// with the TPU kernel's roundings: P is rounded to dO's dtype before dV,
// dS to K's dtype before dQ and to Q's dtype before dK, every product
// accumulates in f32, and dq, dk, dv are written in the input dtype; a
// GQA group's dk / dv is summed in f32 before its one rounding (the TPU
// kernel rounds each query head's, then sums). The live (query, key)
// pairs are the forward's (flash_mma.cuh): bottom-right causal, the
// sliding-window band, keys past sk never count.
//
// Bound on the H100: operations at training shapes. The TPU's two kernels
// each recompute S = Q K^T and dP = dO V^T: 14 * D flops per live pair.
// K7 computes them once, 10 * D flops per live pair (S^T, dP^T, dV, dK,
// dQ), against 4 * D bf16 values of q, do, dq and of k, v, dk, dv read or
// written once. At the training shape (B = 1, S = 4,096, H = 32, D =
// 128, causal) that is 8.39 M live pairs per head, 344 GFLOP: 0.347 ms at
// 989 TFLOP/s, against ~0.02 ms for its bytes.
//
// Design of the bf16 kernel K7 (`bwd_fused_wgmma_kernel`; the fp16 arm is
// the same template on `__half`: wgmma's f16 instruction, TMA's FLOAT16
// maps, P^T and dS^T rounded to fp16 where the bf16 arm rounds them to
// bf16, every accumulator, lse and delta f32).
// - One CTA per (batch, KV head, 128-key tile), 8 warps. K and V stay in
//   shared memory for the whole walk; the CTA walks the 64-row query
//   tiles that hold a live pair with its keys (highest first) and, for
//   each, the G query heads of its KV head's group, and sums dk and dv of
//   all of them in f32 registers: no atomics and no repeated K / V per
//   query head. Q, dO, lse and delta stream through a three-stage ring
//   (Q and dO by TMA from one thread, lse and delta by cp.async): two
//   steps' copies are in flight while one computes.
// - Per step, on Hopper's tensor cores (wgmma.cuh; two warpgroups, each
//   owning 64 keys, f32 accumulators): S^T = K Q^T and dP^T = V dO^T (A
//   and B from shared memory), each its own commit group so P^T is formed
//   while dP^T is in flight; dV += P^T dO, in flight while dS^T is formed,
//   and dK += dS^T Q, with P^T / dS^T re-packed from the accumulators as
//   register A operands (exp2 in one MUFU instruction); dS^T goes once to
//   shared memory, and dQ_partial = dS K takes it as A (each warpgroup D /
//   2 columns of the 64 query rows).
// - dq is a reduction across CTAs, kept deterministic by a fixed order of
//   adds (no free atomics): the partial is staged in shared memory (f32,
//   rows padded by 4 so the fragment stores hit distinct banks) and sent
//   to an f32 workspace tile (B, H, query tile, 64, D + 4) as one bulk
//   copy (the first contributor) or one bulk reduce-add
//   (`cp.reduce.async.bulk`, the others); the last contributor reads the
//   workspace, adds its partial in registers and writes dq in bf16.
//   The order (ops/flash_attention.py `BwdSchedule`, which states it in
//   Python and which the tests rehearse): each CTA claims its work item
//   from a ticket counter at its start, key tiles ascending with the
//   (batch, KV head) pairs interleaved, so causal masking's long walks
//   start first; each (batch, query head, query tile) takes its adds in
//   ascending key-tile order, and a per-tile counter says how many have
//   landed. A CTA waits only for the key tile just below its own, whose
//   ticket is earlier; every claimed ticket belongs to a running CTA and
//   the earliest unfinished one waits on nobody, so the waits cannot
//   deadlock. Under causal masking every walk starts at the last query
//   tile, so key tile j - 1 stays ahead of key tile j once it started a
//   step earlier: only the first wave waits. A CTA releases a tile's
//   counter once its bulk op has completed, in its next step after its
//   first products (or at its end), and never while it waits itself.
// The f32 kernel (`bwd_fused_f32_kernel`, the route of an f32 model) keeps
// K7's walk, work order and dq order (BwdSchedule at its own key tile: 128
// keys at D = 128, 64 at D = 64) and computes the same five products per
// live pair on mma.sync TF32 as 3xTF32 (bwd_f32.cuh), 3 x 10 * D TF32
// flops per live pair: 1,031 GFLOP at the training shape, 2.08 ms at 495
// TFLOP/s. Its dq adds go straight into the f32 dq in the same fixed
// order, so two calls are bit-equal.
#include "bwd_f32.cuh"
#include "bwd_fused.cuh"
#include "common.cuh"
#include "flash_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

using namespace ptt;
using namespace ptt::flash;
using namespace ptt::bwd;

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

// The query range [lo, hi) that sees at least one of the keys
// [k0, k0 + BK): the transpose of key_range (`_q_band_clamp`).
template <int BK>
__device__ __forceinline__ void query_range(const Dims& s, int k0, int* lo,
                                            int* hi) {
  int l = 0, u = s.sq;
  if (s.causal) {
    l = max(0, k0 - s.off);
    if (s.window > 0) u = min(u, min(k0 + BK, s.sk) - 1 - s.off + s.window);
  }
  *lo = l;
  *hi = u;
}

// ------------------------------------------------------------- K7 bf16
constexpr int kFBK = 128;             // keys per CTA
constexpr int kFWarps = kFBK / 16;    // each warp owns 16 keys
constexpr int kFThreads = 32 * kFWarps;

// Every pair of the query tile at q0 and the key tile at k0 is live, and
// both tiles are whole (rows past sq would add to dk / dv).
__device__ __forceinline__ bool fused_full_pair(const Dims& s, int q0,
                                                int k0) {
  if (q0 + kBQ > s.sq || k0 + kFBK > s.sk) return false;
  if (!s.causal) return true;
  if (k0 + kFBK - 1 > q0 + s.off) return false;
  return s.window <= 0 || k0 > q0 + kBQ - 1 + s.off - s.window;
}

// ------------------------------------------------------- K7 bf16, wgmma
// Byte offsets of the wgmma kernel's shared memory at head width D: the
// bf16 tiles are blocked (wgmma.cuh), without padding.
template <int D>
struct WgSmem {
  static constexpr size_t kv_bytes = sizeof(bf16) * kFBK * D;  // or fp16
  static constexpr size_t q_bytes = sizeof(bf16) * kBQ * D;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kv_bytes;
  static constexpr size_t q = v + kv_bytes;          // [3 stages]
  static constexpr size_t dout = q + 3 * q_bytes;    // [3 stages]
  static constexpr size_t dst = dout + 3 * q_bytes;  // dS^T [kFBK][kBQ]
  static constexpr size_t stage = dst + sizeof(bf16) * kFBK * kBQ;
  static constexpr size_t lse = stage + sizeof(float) * kBQ * (D + 4);
  static constexpr size_t delta = lse + sizeof(float) * 3 * kBQ;  // [3][kBQ]
  static constexpr size_t bars = delta + sizeof(float) * 3 * kBQ;  // full[3]
  // and 1 KB of room to align the base to the 128-byte swizzle's atoms
  static constexpr size_t bytes = bars + sizeof(uint64_t) * 3 + 1024;
  static_assert(stage % 16 == 0, "bulk copies read 16-byte aligned rows");
};

// K7 on Hopper's wgmma: two warpgroups, each owning 64 of the CTA's 128
// keys. Per step S^T, dP^T (A = K / V, B = Q / dO, both K-major from
// shared memory), dV += P^T dO and dK += dS^T Q (A = P^T / dS^T from
// registers, B = dO / Q MN-major), and dQ = dS K (A = dS^T, written once
// to shared memory, and B = K, both MN-major; each warpgroup takes half
// of D); the walk and the dq order are the header's. The ring has three
// stages: thread 0 asks TMA for each step's Q and dO boxes
// (128-byte swizzle, completing on the stage's mbarrier), the threads
// copy lse and delta with cp.async; K and V (blocked, no swizzle) are
// copied once by cp.async.
template <int D, typename T>
__global__ void __launch_bounds__(kFThreads, 1)
    bwd_fused_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, T* __restrict__ dk,
                           T* __restrict__ dv, float* __restrict__ ws,
                           int* __restrict__ sync, Dims s, int nb) {
  using M = WgSmem<D>;
  constexpr int kRow8 = 16 * D;   // bytes between 8-row groups of a tile
  constexpr int kNtS = kBQ / 8;   // score n-tiles (8 queries)
  constexpr int kNtO = D / 8;
  constexpr int kNtQ = D / 16;    // dq n-tiles of a warpgroup (half of D)
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  unsigned char* smem_raw =
      smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + M::bars);
  T* ks = reinterpret_cast<T*>(smem_raw + M::k);
  T* vs = reinterpret_cast<T*>(smem_raw + M::v);
  T* qs = reinterpret_cast<T*>(smem_raw + M::q);
  T* dos = reinterpret_cast<T*>(smem_raw + M::dout);
  char* dst = reinterpret_cast<char*>(smem_raw + M::dst);
  float* stg = reinterpret_cast<float*>(smem_raw + M::stage);
  float* ls = reinterpret_cast<float*>(smem_raw + M::lse);
  float* dls = reinterpret_cast<float*>(smem_raw + M::delta);
  __shared__ int ticket;

  // the work item: ticket = (j * nb + batch) * hk + kv_head
  if (threadIdx.x == 0) {
    ticket = atomicAdd(sync, 1);
    for (int i = 0; i < 3; ++i) mbar_init(full + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int j = ticket / (nb * s.hk);
  const int b = ticket / s.hk % nb;
  const int kvh = ticket % s.hk;
  const int k0 = j * kFBK;
  const int grp = s.h / s.hk;
  const int nq = (s.sq + kBQ - 1) / kBQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wgi = warp >> 2;  // the warpgroup: keys 64 wgi .. 64 wgi + 63
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t kv_stride = static_cast<size_t>(s.hk) * D;
  const size_t kv_off = (static_cast<size_t>(b) * s.sk * s.hk + kvh) * D;

  int lo, hi;
  query_range<kFBK>(s, k0, &lo, &hi);
  const int ihi = (hi - 1) / kBQ;
  const int items = hi > lo ? (ihi - lo / kBQ + 1) * grp : 0;

  auto load_step = [&](int t, int st) {
    const int q0 = (ihi - t / grp) * kBQ;
    const int head = kvh * grp + t % grp;
    if (threadIdx.x == 0) {
      mbar_expect_tx(full + st, 2 * sizeof(T) * kBQ * D);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_box(qs + st * kBQ * D + c * 64 * kBQ, &qmap, c * 64, head, q0, b,
                full + st);
        tma_box(dos + st * kBQ * D + c * 64 * kBQ, &dmap, c * 64, head, q0, b,
                full + st);
      }
    }
    const size_t row0 = (static_cast<size_t>(b) * s.h + head) * s.sq;
    for (int r = threadIdx.x; r < kBQ; r += kFThreads) {
      const bool ok = q0 + r < s.sq;
      cp_async4(ls + st * kBQ + r, lse + (ok ? row0 + q0 + r : 0), ok);
      cp_async4(dls + st * kBQ + r, delta + (ok ? row0 + q0 + r : 0), ok);
    }
  };

  load_rows_blocked<D, kFBK, kFThreads>(ks, k + kv_off, kv_stride, k0, s.sk);
  load_rows_blocked<D, kFBK, kFThreads>(vs, v + kv_off, kv_stride, k0, s.sk);
  if (items > 0) load_step(0, 0);
  cp_async_commit();
  if (items > 1) load_step(1, 1);
  cp_async_commit();

  float adk[kNtO][4], adv[kNtO][4];
#pragma unroll
  for (int i = 0; i < kNtO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;
  const float scale_log2 = s.scale * kLog2e;
  const int lk = warp * 16 + g;    // the thread's keys lk, lk + 8
  const int mq = (warp & 3) * 16;  // the warp's dq rows
  const int nc = wgi * (D / 2);    // the warpgroup's dq columns
  // the warpgroup's K and V rows (A of S^T and dP^T), and K's columns of
  // its dq half (B of dQ)
  const uint32_t ka = smem_u32(ks) + wgi * 8 * kRow8;
  const uint32_t va = smem_u32(vs) + wgi * 8 * kRow8;
  const uint32_t kb = smem_u32(ks) + wgi * (D / 16) * 128;
  const uint32_t sa = smem_u32(dst);
  int pending = 0, pending_val = 0;

  for (int t = 0; t < items; ++t) {
    const int st = t % 3;
    const int i = ihi - t / grp;
    const int head = kvh * grp + t % grp;
    const int q0 = i * kBQ;
    cp_async_wait<1>();    // lse, delta (and K, V) of this step
    fence_async_shared();  // K and V are read by wgmma (async proxy)
    // this stage has landed, and both warpgroups are done with the last
    // step (their wgmma reads of its stage, of dS^T and of the staging):
    // only now may step t + 2's copy overwrite that stage
    __syncthreads();
    if (t + 2 < items) load_step(t + 2, (t + 2) % 3);
    cp_async_commit();  // one group a step, empty or not
    mbar_wait(full + st, (t / 3) & 1);  // this step's Q and dO boxes
    const uint32_t qa = smem_u32(qs + st * kBQ * D);
    const uint32_t da = smem_u32(dos + st * kBQ * D);
    const float* lt = ls + st * kBQ;
    const float* dlt = dls + st * kBQ;
    const bool full = fused_full_pair(s, q0, k0);

    // -lse log2(e) and delta of the thread's 16 query columns
    float nl[kNtS][2], dl[kNtS][2];
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        nl[nt][e] = -lt[nt * 8 + tig * 2 + e] * kLog2e;
        dl[nt][e] = dlt[nt * 8 + tig * 2 + e];
      }

    // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 keys x 64 queries,
    // each its own commit group so P is formed while dP^T is in flight
    float sc[kNtS][4], dp[kNtS][4];
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::ss<kBQ, 0, 0, T>(&sc[0][0], wg::desc(ka + kk * 256, 128, kRow8),
                        wg::desc_sw128(qa + kk / 4 * 8192 + kk % 4 * 32, 16,
                                       1024), 1);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::ss<kBQ, 0, 0, T>(&dp[0][0], wg::desc(va + kk * 256, 128, kRow8),
                        wg::desc_sw128(da + kk / 4 * 8192 + kk % 4 * 32, 16,
                                       1024), 1);
    wg::commit();
    wg::wait<1>();
    wg::fence_regs<4 * kNtS>(&sc[0][0]);

    // P^T in sc (dead pairs 0 by a select), then dV += P^T dO (P^T rounded
    // to T, A from registers; B MN-major: rows are the queries), in
    // flight while dS^T is formed
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + tig * 2 + (e & 1);
        const bool live =
            full || (q0 + c < s.sq &&
                     band_live(s, q0 + c, k0 + lk + (e >> 1) * 8));
        sc[nt][e] =
            live ? exp2_ftz(fmaf(sc[nt][e], scale_log2, nl[nt][e & 1])) : 0.f;
      }
    uint32_t ap[kBQ / 16][4], ads[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) pack_a<T>(ap[kk], sc, kk);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wg::rs<D, 1, T>(&adv[0][0], ap[kk],
                   wg::desc_sw128(da + kk * 2048, 8192, 1024), 1);
    wg::commit();
    wg::wait<1>();
    wg::fence_regs<4 * kNtS>(&dp[0][0]);

    // dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q (dS^T rounded to
    // T)
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = sc[nt][e] * (dp[nt][e] - dl[nt][e & 1]) * s.scale;
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) pack_a<T>(ads[kk], dp, kk);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wg::rs<D, 1, T>(&adk[0][0], ads[kk],
                   wg::desc_sw128(qa + kk * 2048, 8192, 1024), 1);
    wg::commit();

    // dS^T (in T) into its blocked tile, rows the keys
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(
            dst + wg::chunk_offset<kBQ>(lk + half * 8, nt) + tig * 4) =
            ads[nt >> 1][(nt & 1) * 2 + half];
    fence_async_shared();
    // the previous step's bulk op has had this step's products to land
    release_dq(sync, &pending, pending_val);
    __syncthreads();  // dS^T is complete

    // dQ_partial = dS K: the tile's 64 queries x the warpgroup's D / 2
    // columns (A = dS^T, B = K, both MN-major: rows are the keys)
    float dqa[kNtQ][4];
#pragma unroll
    for (int nd = 0; nd < kNtQ; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kFBK / 16; ++kk)
      wg::ss<D / 2, 1, 1, T>(&dqa[0][0],
                          wg::desc(sa + kk * 2 * (16 * kBQ), 16 * kBQ, 128),
                          wg::desc(kb + kk * 2 * kRow8, kRow8, 128), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs<4 * kNtO>(&adv[0][0]);
    wg::fence_regs<4 * kNtO>(&adk[0][0]);
    wg::fence_regs<4 * kNtQ>(&dqa[0][0]);

    // this key tile's place in query tile i's add order: ascending key
    // tiles from the first that reaches it
    int klo, khi;
    key_range(s, q0, &klo, &khi);
    const int rank = j - klo / kFBK;
    add_dq<D>(dqa, rank == 0, j == (khi - 1) / kFBK, sync,
              1 + (b * s.h + head) * nq + i, rank, rank + 1, ws, dq,
              static_cast<size_t>(b) * s.sq + q0, s.h, head, s.sq - q0, mq,
              nc, stg, &pending, &pending_val);
  }
  release_dq(sync, &pending, pending_val);
  cp_async_wait<0>();  // a CTA without steps still has K and V in flight
  store_rows<D>(dk + kv_off, kv_stride, adk, k0 + lk, s.sk, tig);
  store_rows<D>(dv + kv_off, kv_stride, adv, k0 + lk, s.sk, tig);
}

// ------------------------------------------------------------- K7 f32
// K7's walk and dq order in f32 on bwd_f32.cuh's 3xTF32 tile math: one CTA
// per (batch, KV head, BK-key tile), BK / 16 warps of 16 keys; K and V
// resident, Q (with lse and delta) and dO one step at a time: the next
// step's Q is copied while dQ runs, its dO while the next S^T runs.
template <int D>
using F32 = bwd32::Shape<D>;

// Every pair of the query tile at q0 and the BK-key tile at k0 is live,
// and both tiles are whole.
template <int BK>
__device__ __forceinline__ bool f32_full_pair(const Dims& s, int q0,
                                              int k0) {
  if (q0 + kBQ > s.sq || k0 + BK > s.sk) return false;
  if (!s.causal) return true;
  if (k0 + BK - 1 > q0 + s.off) return false;
  return s.window <= 0 || k0 > q0 + kBQ - 1 + s.off - s.window;
}

template <int D>
__global__ void __launch_bounds__(F32<D>::kThreads, D == 64 ? 3 : 1)
    bwd_fused_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, int* __restrict__ sync,
                         Dims s, int nb) {
  using M = F32<D>;
  constexpr int BK = M::BK;
  constexpr int kThreads = M::kThreads;
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f + M::k_off;
  float* vs = smem_f + M::v_off;
  float* qs = smem_f + M::q_off;
  float* dos = smem_f + M::do_off;  // dO, then dS^T
  float* ls = smem_f + M::lse_off;
  float* dls = smem_f + M::delta_off;
  __shared__ int ticket;

  // the work item: ticket = (j * nb + batch) * hk + kv_head
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int j = ticket / (nb * s.hk);
  const int b = ticket / s.hk % nb;
  const int kvh = ticket % s.hk;
  const int k0 = j * BK;
  const int grp = s.h / s.hk;
  const int nq = (s.sq + kBQ - 1) / kBQ;
  const int warp = threadIdx.x >> 5;
  const int lk = warp * 16 + ((threadIdx.x & 31) >> 2);  // keys lk, lk + 8
  const int mq = (warp & 3) * 16;  // the warp's dq rows
  const int nc = (warp >> 2) * M::NC;  // and columns
  const size_t kv_stride = static_cast<size_t>(s.hk) * D;
  const size_t kv_off = (static_cast<size_t>(b) * s.sk * s.hk + kvh) * D;
  const size_t q_stride = static_cast<size_t>(s.h) * D;

  int lo, hi;
  query_range<BK>(s, k0, &lo, &hi);
  const int ihi = (hi - 1) / kBQ;
  const int items = hi > lo ? (ihi - lo / kBQ + 1) * grp : 0;

  // step t's Q, lse and delta; its dO
  auto load_q = [&](int t) {
    const int q0 = (ihi - t / grp) * kBQ;
    const int head = kvh * grp + t % grp;
    bwd32::load_rows_f32<D, kBQ, kThreads>(
        qs, q + (static_cast<size_t>(b) * s.sq * s.h + head) * D, q_stride,
        q0, s.sq);
    const size_t row0 = (static_cast<size_t>(b) * s.h + head) * s.sq;
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const bool ok = q0 + r < s.sq;
      cp_async4(ls + r, lse + (ok ? row0 + q0 + r : 0), ok);
      cp_async4(dls + r, delta + (ok ? row0 + q0 + r : 0), ok);
    }
  };
  auto load_do = [&](int t) {
    const int q0 = (ihi - t / grp) * kBQ;
    const int head = kvh * grp + t % grp;
    bwd32::load_rows_f32<D, kBQ, kThreads>(
        dos, dout + (static_cast<size_t>(b) * s.sq * s.h + head) * D,
        q_stride, q0, s.sq);
  };

  bwd32::load_rows_f32<D, BK, kThreads>(ks, k + kv_off, kv_stride, k0, s.sk);
  bwd32::load_rows_f32<D, BK, kThreads>(vs, v + kv_off, kv_stride, k0, s.sk);
  if (items > 0) load_q(0);
  cp_async_commit();

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;
  int* pending = nullptr;  // thread 0: the counter of an add in flight
  int pending_val = 0;

  for (int t = 0; t < items; ++t) {
    const int i = ihi - t / grp;
    const int head = kvh * grp + t % grp;
    const int q0 = i * kBQ;
    const bool full = f32_full_pair<BK>(s, q0, k0);
    cp_async_wait<0>();  // Q, lse, delta (and K, V) of this step
    bwd32::bulk_wait_read();  // the last dq add has read its staging
    __syncthreads();
    load_do(t);  // into the dO tile, while S^T runs
    cp_async_commit();

    float sc[kBQ / 8][4], dp[kBQ / 8][4];
    bwd32::rows_by_rows<D>(ks, warp * 16, qs, sc);  // S^T = K Q^T
    bwd32::probs(sc, ls, s.scale, [&](int c, int half) {
      return full ||
             (q0 + c < s.sq && band_live(s, q0 + c, k0 + lk + half * 8));
    });
    // the last step's dq add has had this step's first products to land
    bwd32::release_dq_f32(&pending, pending_val);
    cp_async_wait<0>();  // dO of this step
    __syncthreads();
    bwd32::acc_by_rows<D>(sc, dos, adv);            // dV += P^T dO
    bwd32::rows_by_rows<D>(vs, warp * 16, dos, dp);  // dP^T = V dO^T
    bwd32::dsoft(dp, sc, dls, s.scale);
    bwd32::acc_by_rows<D>(dp, qs, adk);  // dK += dS^T Q
    __syncthreads();  // every warp is done with Q and dO
    if (t + 1 < items) load_q(t + 1);
    cp_async_commit();
    bwd32::store_dst(dos, warp * 16, dp);
    __syncthreads();  // dS^T is complete
    float dqa[8][4];
    bwd32::dq_partial<D>(dos, ks, mq, nc, dqa);  // dQ = dS K
    __syncthreads();  // every warp is done with dS^T: the staging is free

    // this key tile's place in query tile i's add order: ascending key
    // tiles from the first that reaches it
    int klo, khi;
    key_range(s, q0, &klo, &khi);
    const int rank = j - klo / BK;
    int* counter = sync + 1 + (b * s.h + head) * nq + i;
    bwd32::add_dq_f32<D>(dqa, rank == 0, counter, rank,
                         dq + (static_cast<size_t>(b) * s.sq + q0) *
                                  q_stride +
                             static_cast<size_t>(head) * D,
                         q_stride, s.sq - q0, mq, nc, dos);
    pending = counter;
    pending_val = rank + 1;
  }
  bwd32::release_dq_f32(&pending, pending_val);
  cp_async_wait<0>();  // a CTA without steps still has K and V in flight
  bwd32::store_rows_f32<D>(dk + kv_off, kv_stride, adk, k0 + warp * 16, s.sk);
  bwd32::store_rows_f32<D>(dv + kv_off, kv_stride, adv, k0 + warp * 16, s.sk);
}

// ------------------------------------------------------------- launch
bool valid(int sk, int h, int hk, int d, int causal, int window) {
  return sk >= 0 && hk > 0 && h % hk == 0 && (d == 64 || d == 128) &&
         window >= 0 && (window == 0 || causal);
}

template <int D, typename T>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, float* ws, int* sync,
                 const Dims& s, int b, int items, cudaStream_t st) {
  static bool configured = false;
  constexpr CUtensorMapDataType dt = wg::kIsF16<T>
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap, dmap;
  if (int e = make_map(&qmap, q, b, s.sq, s.h, D, dt)) return e;
  if (int e = make_map(&dmap, dout, b, s.sq, s.h, D, dt)) return e;
  constexpr size_t bytes = WgSmem<D>::bytes;
  if (int e = set_smem(bwd_fused_wgmma_kernel<D, T>, bytes, &configured))
    return e;
  bwd_fused_wgmma_kernel<D, T><<<items, kFThreads, bytes, st>>>(
      qmap, dmap, static_cast<const T*>(k), static_cast<const T*>(v), lse,
      delta, static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      ws, sync, s, b);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fused_f32(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, int* sync, const Dims& s,
                     int b, int items, cudaStream_t st) {
  static bool configured = false;
  constexpr size_t bytes = F32<D>::bytes;
  if (int e = set_smem(bwd_fused_f32_kernel<D>, bytes, &configured))
    return e;
  bwd_fused_f32_kernel<D><<<items, F32<D>::kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), sync, s, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7. q, do, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, HK, D); lse, delta
// (B, H, Sq) f32; all contiguous, of one dtype (bf16, fp16 or f32) but lse and
// delta. D is 64 or 128; window 0 means none (needs causal). counters are
// 1 + B * H * ceil(Sq / 64) int32 zeros (the ticket, then one counter per
// (batch, head, query tile)); dk, dv are each KV head's sum over the query
// heads of its group. Rows of a query tile no key tile reaches (sq > sk,
// causal) are not written. bf16 / fp16: dq_ws is the f32 workspace (B, H,
// ceil(Sq / 64), 64, D + 4), CTAs of 128 keys; f32: dq takes the adds
// itself (dq_ws unused), CTAs of 128 keys at D = 128 and 64 at D = 64.
extern "C" int ptt_flash_attention_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    void* dq_ws, void* counters, int b, int sq, int sk, int h, int hk,
    int d, int causal, int window, float sm_scale, int dtype, void* stream) {
  if (b <= 0 || sk <= 0) return 0;
  const bool f32 = dtype == kF32;
  const int bk = f32 && d == 64 ? F32<64>::BK : kFBK;
  const long long items = static_cast<long long>((sk + bk - 1) / bk) * b * hk;
  if (sq < 0 || (dtype != kBF16 && dtype != kF16 && !f32) ||
      !valid(sk, h, hk, d, causal, window) || items > 0x7fffffffLL ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv) ||
      (!f32 && !aligned16(dq_ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims s{sq, sk, h, hk, causal, window, sk - sq, sm_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* ws = static_cast<float*>(dq_ws);
  int* sync = static_cast<int*>(counters);
  const int n = static_cast<int>(items);
  if (f32)
    return d == 64 ? launch_fused_f32<64>(q, k, v, dout, l, dl, dq, dk, dv,
                                          sync, s, b, n, st)
                   : launch_fused_f32<128>(q, k, v, dout, l, dl, dq, dk, dv,
                                           sync, s, b, n, st);
  if (dtype == kF16)
    return d == 64 ? launch_fused<64, f16>(q, k, v, dout, l, dl, dq, dk, dv,
                                           ws, sync, s, b, n, st)
                   : launch_fused<128, f16>(q, k, v, dout, l, dl, dq, dk,
                                            dv, ws, sync, s, b, n, st);
  return d == 64 ? launch_fused<64, bf16>(q, k, v, dout, l, dl, dq, dk, dv,
                                          ws, sync, s, b, n, st)
                 : launch_fused<128, bf16>(q, k, v, dout, l, dl, dq, dk, dv,
                                           ws, sync, s, b, n, st);
}
