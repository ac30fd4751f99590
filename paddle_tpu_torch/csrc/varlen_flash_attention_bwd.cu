// Varlen (packed) flash attention backward for Hopper: K8, one fused kernel
// for dq, dk and dv, in bf16 on wgmma and in f32 on the tensor cores as
// 3xTF32.
//
// Replaces: paddle_tpu/ops/pallas/varlen_flash_attention.py, `_varlen_bwd`
// -> `_bwd_dq_kernel` (its pl.pallas_call at :336) and `_bwd_dkv_kernel`
// (:376). Sequences are packed back to back, q / do / dq (Tq, H, D) and k
// / v / dk / dv (Tk, HK, D), with cu_seqlens prefix sums; lse and delta =
// rowsum(dO * O) are (H, Tq) f32 (the forward K3 writes lse; the wrapper
// computes delta). Both TPU kernels recompute the probabilities from lse,
// P = exp(S * scale - lse):
//   dS = P * (dO V^T - delta) * scale
//   dQ = dS K            dK = dS^T Q            dV = P^T dO
// with the TPU kernel's roundings: P is rounded to dO's dtype before dV,
// dS to K's dtype before dQ and to Q's dtype before dK, every product
// accumulates in f32, and dq, dk, dv are written in the input dtype; a
// GQA group's dk / dv is summed in f32 before its one rounding (the TPU
// kernel rounds each query head's, then sums). The live pairs are K3's
// (varlen_seg.cuh): one segment, bottom-right causal per segment, the
// per-segment window. A masked pair's probability is taken to 0 by a
// select before it is used (a row with no live key has lse ~ -1e30 and
// exp(s - lse) overflows there), so such rows and padding rows past
// cu_seqlens_q[-1] get dq = 0, and a key no query sees gets dk = dv = 0.
//
// Bound on the H100: operations at training shapes. The TPU's two kernels
// each recompute S = Q K^T and dP = dO V^T: 14 * D flops per live pair. K8
// computes them once, 10 * D flops per live pair (S^T, dP^T, dV, dK, dQ).
// At the packed 941M configuration (T = 4,096 in 8 segments of 1,600 ..
// 76 tokens, H = HK = 32, D = 64, causal: 61.99 M live pairs) that is 39.7
// GFLOP, 0.040 ms at 989 TFLOP/s, above the ~0.035 ms its ~118 MB of q,
// do, dq, k, v, dk, dv, lse and delta take at 3.35 TB/s.
//
// Design of the bf16 kernel K8 (`varlen_bwd_fused_kernel`): K7's
// (flash_attention_bwd.cu, bwd_fused.cuh) with the segment masks in place
// of the dense band.
// - One CTA per (KV head, key tile), one warpgroup per 64 keys: 128 keys
//   on two warpgroups at D = 128; 64 keys on one at D = 64, where two CTAs
//   share an SM and each hides the other's barriers, dq waits and
//   prologue (a 128-key CTA there runs alone and spends a fifth of its
//   time before its first product). K and V stay in shared memory for the
//   whole walk. The CTA walks the 64-row query tiles that hold a live pair
//   with any of its 64-key halves, highest first, and for each the G
//   query heads of its group, summing dk and dv in f32 registers. The walk is found before the first copy,
//   a chunk of up to 256 query tiles at a time, one tile a thread: its
//   state against each half (varlen_seg.cuh's 64-row `Walk` inside one
//   segment, `runs_live` across segments; a dead tile's Q / dO bytes are
//   never read) and its dq order, packed in order into a shared list, so
//   no segment search sits between two steps. A pair's mask is one
//   interval test: each key knows the queries that see it
//   (`key_queries`), and a tile whose pairs are all live skips it. A half
//   with no live pair in a tile still runs its products (all its P are
//   0): guarding a product would make ptxas serialize every wgmma.
// - Q and dO come by TMA (a (1, Tq, H, D) tensor map; rows past Tq read
//   as zeros) into a three-stage ring from one thread, lse and delta by
//   cp.async; the products are K7's on wgmma: S^T = K Q^T and dP^T = V
//   dO^T (shared A and B, each its own commit group), dV += P^T dO and dK
//   += dS^T Q (register A re-packed from the accumulators, exp2 in one MUFU
//   instruction), dS^T once to shared memory and dQ_partial = dS K.
// - dq by ordered bulk reduce-adds (bwd_fused.cuh) into an f32 workspace
//   (H, ceil(Tq / 64), 64, D + 4) with one counter per (query head, query
//   tile); the order is ops/varlen_flash_attention.py `VarlenBwdSchedule`,
//   which states it in Python and which the tests rehearse. Each CTA
//   claims its item from a ticket counter at its start, ticket = j * HK +
//   kv_head: key tiles ascending, KV heads interleaved. A query tile takes
//   its adds from its live contributors only (the key tiles with a
//   live pair with its rows; in a packed batch a key tile inside its key
//   range may be dead), in ascending key-tile order: the counter holds 1 +
//   the key tile of the last add landed, and a contributor waits for its
//   predecessor (the nearest live key tile below it, found by `runs_live`
//   inside the tile's key_range_of), whose ticket is earlier. Every
//   claimed ticket belongs to a running CTA and the earliest unfinished one
//   waits on nobody, so the waits cannot deadlock; each wait traps after a
//   bound instead of hanging the card. A query tile with no contributor
//   (padding rows, rows that see no key) gets dq = 0 from the CTA whose
//   ticket is its index (modulo the grid), at that CTA's end.
// The f32 kernel (`varlen_bwd_fused_f32_kernel`, the route of an f32
// model) keeps K8's CTA shape, walk, work order and dq order
// (VarlenBwdSchedule) and computes the same five products per live pair on
// mma.sync TF32 as 3xTF32 (bwd_f32.cuh): 3 x 39.7 GFLOP at the packed
// 941M row, 0.24 ms at 495 TFLOP/s. Its dq adds go straight into the f32
// dq in the same fixed order, so two calls are bit-equal.
#include "bwd_f32.cuh"
#include "bwd_fused.cuh"
#include "common.cuh"
#include "flash_mma.cuh"
#include "tma.cuh"
#include "varlen_seg.cuh"
#include "wgmma.cuh"

using namespace ptt;
using namespace ptt::varlen;
using namespace ptt::bwd;

namespace {

namespace fl = ptt::flash;
using bf16 = __nv_bfloat16;
using fl::cp_async4;
using fl::cp_async_commit;
using fl::cp_async_wait;
using fl::exp2_ftz;
using fl::kLog2e;
using fl::pack_a;
using fl::set_smem;
using fl::store_rows;

static_assert(fl::kBQ == kTile && bwd32::kBQ == kTile,
              "K8 shares the 64-row tiles of flash_mma.cuh, bwd_f32.cuh "
              "and varlen_seg.cuh");

// ---------------------------------------------------------------- K8 bf16
// The segment searches of a CTA read cu_seqlens from shared memory, where a
// batch has at most kCuSmem - 1 segments (else from global memory): on an
// H100 the shared copy takes 2-8% off K8 at chip_smoke.py's shapes
// (scripts/torch_ab_varlen_bwd.py, both forms alternated on one card).
constexpr int kCuSmem = 1024;

// The CTA shape of K8 at head width D: BK keys on BK / 64 warpgroups, 128
// keys on two at D = 128, 64 keys on one at D = 64, where two CTAs fit an
// SM.
template <int D>
struct Shape {
  static constexpr int BK = D == 64 ? 64 : 128;  // keys per CTA
  static constexpr int W = BK / kTile;          // warpgroups
  static constexpr int kThreads = 128 * W;
  static constexpr int kWarps = 4 * W;
  static constexpr int NC = D / W;  // dq columns of a warpgroup
};

// Byte offsets of K8's shared memory at head width D: the bf16 tiles are
// blocked (wgmma.cuh; K, V, dS^T) or TMA boxes with the 128-byte swizzle
// (Q, dO), without padding.
template <int D>
struct FusedSmem {
  static constexpr int BK = Shape<D>::BK;
  static constexpr size_t kv_bytes = sizeof(bf16) * BK * D;
  static constexpr size_t q_bytes = sizeof(bf16) * kTile * D;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kv_bytes;
  static constexpr size_t q = v + kv_bytes;          // [3 stages]
  static constexpr size_t dout = q + 3 * q_bytes;    // [3 stages]
  static constexpr size_t dst = dout + 3 * q_bytes;  // dS^T [BK][kTile]
  static constexpr size_t stage = dst + sizeof(bf16) * BK * kTile;
  static constexpr size_t lse = stage + sizeof(float) * kTile * (D + 4);
  static constexpr size_t delta = lse + sizeof(float) * 3 * kTile;
  // the walk: a chunk of up to one live query tile a thread (tile,
  // previous contributor, states and last flag)
  static constexpr size_t walk = delta + sizeof(float) * 3 * kTile;
  // cu_seqlens_q and _k of up to kCuSmem entries each
  static constexpr size_t cu = walk + sizeof(int) * 3 * Shape<D>::kThreads;
  static constexpr size_t bars = cu + sizeof(int) * 2 * kCuSmem;
  // and 1 KB of room to align the base to the 128-byte swizzle's atoms
  static constexpr size_t bytes = bars + sizeof(uint64_t) * 3 + 1024;
  static_assert(q % 1024 == 0 && q_bytes % 1024 == 0 && stage % 16 == 0 &&
                    bars % 8 == 0,
                "TMA boxes 1024-byte aligned, bulk rows 16-byte aligned");
};

// One step of a CTA's walk: query tile i (-1 once the walk is over), head
// g of the KV head's group, the tile's state against each 64-key half,
// and the tile's dq order: the key tile of the previous contributor (-1:
// this one is the first) and whether this one is the last.
struct Step {
  int i, g, st0, st1, prev, last;
};

// K8 on Hopper's wgmma; the products and the dq reduction are K7's, the
// walk and the order the header's.
template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads, 3 - Shape<D>::W)
    varlen_bwd_fused_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap dmap,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ cu_q_g,
                            const int* __restrict__ cu_k_g,
                            bf16* __restrict__ dq, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, float* __restrict__ ws,
                            int* __restrict__ sync, Seg s) {
  using M = FusedSmem<D>;
  constexpr int BK = Shape<D>::BK;
  constexpr int W = Shape<D>::W;
  constexpr int kThreads = Shape<D>::kThreads;
  constexpr int NC = Shape<D>::NC;
  constexpr int kRow8 = 16 * D;  // bytes between 8-row groups of a tile
  constexpr int kNtS = kTile / 8;  // score n-tiles (8 queries)
  constexpr int kNtO = D / 8;
  constexpr int kNtQ = NC / 8;  // dq n-tiles of a warpgroup
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  unsigned char* smem_raw =
      smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + M::bars);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + M::k);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + M::v);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + M::q);
  bf16* dos = reinterpret_cast<bf16*>(smem_raw + M::dout);
  char* dst = reinterpret_cast<char*>(smem_raw + M::dst);
  float* stg = reinterpret_cast<float*>(smem_raw + M::stage);
  float* ls = reinterpret_cast<float*>(smem_raw + M::lse);
  float* dls = reinterpret_cast<float*>(smem_raw + M::delta);
  int* wl_i = reinterpret_cast<int*>(smem_raw + M::walk);
  int* wl_prev = wl_i + kThreads;
  int* wl_flags = wl_prev + kThreads;
  __shared__ int ticket;
  __shared__ Walk walks[W];  // each warpgroup's walk
  __shared__ int wl_warp[Shape<D>::kWarps];

  // the work item: ticket = j * hk + kv_head; cu_seqlens into shared memory
  if (threadIdx.x == 0) {
    ticket = atomicAdd(sync, 1);
    for (int i = 0; i < 3; ++i) mbar_init(full + i, 1);
    mbar_fence_init();
  }
  const bool cu_shared = s.nseg < kCuSmem;
  int* cu_s = reinterpret_cast<int*>(smem_raw + M::cu);
  if (cu_shared)
    for (int i = threadIdx.x; i <= s.nseg; i += kThreads) {
      cu_s[i] = cu_q_g[i];
      cu_s[kCuSmem + i] = cu_k_g[i];
    }
  const int* cu_q = cu_shared ? cu_s : cu_q_g;
  const int* cu_k = cu_shared ? cu_s + kCuSmem : cu_k_g;
  __syncthreads();
  const int j = ticket / s.hk;
  const int kvh = ticket % s.hk;
  const int k0 = j * BK;
  const int grp = s.h / s.hk;
  const int nq = (s.tq + kTile - 1) / kTile;
  // rows at or past cu_q[nseg] and keys at or past cu_k[nseg] are padding
  const int qend = min(s.tq, cu_q[s.nseg]);
  const int kend = min(s.tk, cu_k[s.nseg]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wgi = warp >> 2;  // the warpgroup: keys 64 wgi .. 64 wgi + 63
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t kv_stride = static_cast<size_t>(s.hk) * D;
  const size_t kv_off = static_cast<size_t>(kvh) * D;
  const size_t q_stride = static_cast<size_t>(s.h) * D;

  load_rows_blocked<D, BK, kThreads>(ks, k + kv_off, kv_stride, k0, kend);
  load_rows_blocked<D, BK, kThreads>(vs, v + kv_off, kv_stride, k0, kend);
  // each warpgroup's walk (into shared memory, read after the first
  // fill's barrier) and query range (every thread computes the same); the
  // CTA walks the query tiles of any of the ranges, highest first
  int lo = s.tq, hi = 0;
  for (int w = 0; w < W; ++w) {
    int rlo, rhi;
    const Walk wk = query_walk(cu_q, cu_k, s.nseg, s.tq, kend,
                               k0 + w * kTile, s.causal, s.window, &rlo,
                               &rhi);
    if (threadIdx.x == w) walks[w] = wk;
    if (rlo < rhi) {
      lo = min(lo, rlo);
      hi = max(hi, rhi);
    }
  }
  hi = min(hi, qend);
  const int ilo = lo / kTile;

  // the state of the query tile at q0 against half w's keys
  auto half_state = [&](int w, int q0) -> int {
    if (walks[w].one_seg) return walks[w].state(q0);
    const int kw = k0 + w * kTile;
    return runs_live(cu_q, cu_k, s.nseg, q0, min(q0 + kTile, qend), kw,
                     min(kw + kTile, kend), s.causal, s.window)
               ? kPartial
               : kDead;
  };
  // the dq order of live query tile i: its live contributors are the key
  // tiles inside its key range with a live pair with its rows; *prev the
  // one below this CTA's (-1: none), *last none above it
  auto order = [&](int i, int* prev, int* last) {
    const int q0 = i * kTile;
    const int q1 = min(q0 + kTile, qend);
    int sf, rf, sl, rl, klo, khi;
    query_row(cu_q, cu_k, s.nseg, s.tq, q0, &sf, &rf);
    query_row(cu_q, cu_k, s.nseg, s.tq, q1 - 1, &sl, &rl);
    key_range_of(cu_k, s.tk, sf, rf, sl, rl, s.causal, s.window, &klo, &khi);
    khi = min(khi, kend);
    auto live = [&](int jj) {
      return runs_live(cu_q, cu_k, s.nseg, q0, q1, jj * BK,
                       min(jj * BK + BK, kend), s.causal, s.window);
    };
    *prev = -1;
    for (int jj = j - 1; jj >= klo / BK; --jj)
      if (live(jj)) {
        *prev = jj;
        break;
      }
    *last = 1;
    for (int jj = j + 1; jj * BK < khi; ++jj)
      if (live(jj)) {
        *last = 0;
        break;
      }
  };
  // The walk in chunks: each thread tests one query tile below wl_top
  // (highest first) and finds the dq order of a live one, all in
  // parallel, and the live tiles are packed in order into the shared list
  // (called by every thread; the list is read only between two fills).
  int wl_top = hi > lo ? (hi - 1) / kTile : ilo - 1;
  int wl_pos = 0, wl_len = 0;
  auto fill = [&]() {
    __syncthreads();  // every thread is done with the last chunk
    const int i = wl_top - static_cast<int>(threadIdx.x);
    int st0 = kDead, st1 = kDead, prev = -1, last = 0;
    if (i >= ilo) {
      st0 = half_state(0, i * kTile);
      if constexpr (W > 1) st1 = half_state(1, i * kTile);
      if (st0 != kDead || st1 != kDead) order(i, &prev, &last);
    }
    const bool live = st0 != kDead || st1 != kDead;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) wl_warp[warp] = __popc(ballot);
    __syncthreads();
    int at = __popc(ballot & ((1u << lane) - 1)), total = 0;
    for (int w = 0; w < Shape<D>::kWarps; ++w) {
      at += w < warp ? wl_warp[w] : 0;
      total += wl_warp[w];
    }
    if (live) {
      wl_i[at] = i;
      wl_prev[at] = prev;
      wl_flags[at] = st0 | st1 << 2 | last << 4;
    }
    __syncthreads();
    wl_top -= kThreads;
    wl_pos = 0;
    wl_len = total;
  };
  // the step after c: the next head of the group, else the next live
  // query tile of the walk (every thread computes the same)
  auto advance = [&](Step c) -> Step {
    if (c.i < 0 || ++c.g < grp) return c;
    c.g = 0;
    while (wl_pos == wl_len) {
      if (wl_top < ilo) {
        c.i = -1;
        return c;
      }
      fill();
    }
    c.i = wl_i[wl_pos];
    c.prev = wl_prev[wl_pos];
    const int f = wl_flags[wl_pos++];
    c.st0 = f & 3;
    c.st1 = (f >> 2) & 3;
    c.last = f >> 4;
    return c;
  };
  // Q and dO of step c by TMA (thread 0), lse and delta into stage st
  auto load_step = [&](const Step& c, int st) {
    const int q0 = c.i * kTile;
    const int head = kvh * grp + c.g;
    if (threadIdx.x == 0) {
      mbar_expect_tx(full + st, 2 * sizeof(bf16) * kTile * D);
#pragma unroll
      for (int cc = 0; cc < D / 64; ++cc) {
        tma_box(qs + st * kTile * D + cc * 64 * kTile, &qmap, cc * 64, head,
                q0, 0, full + st);
        tma_box(dos + st * kTile * D + cc * 64 * kTile, &dmap, cc * 64, head,
                q0, 0, full + st);
      }
    }
    const size_t row0 = static_cast<size_t>(head) * s.tq;
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool ok = q0 + r < s.tq;
      cp_async4(ls + st * kTile + r, lse + (ok ? row0 + q0 + r : 0), ok);
      cp_async4(dls + st * kTile + r, delta + (ok ? row0 + q0 + r : 0), ok);
    }
  };

  Step cur{0, grp - 1, 0, 0, -1, 0};
  cur = advance(cur);
  Step nx1 = advance(cur);
  Step nx2 = advance(nx1);
  if (cur.i >= 0) load_step(cur, 0);
  cp_async_commit();
  if (nx1.i >= 0) load_step(nx1, 1);
  cp_async_commit();

  float adk[kNtO][4], adv[kNtO][4];
#pragma unroll
  for (int i = 0; i < kNtO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;
  const float scale_log2 = s.scale * kLog2e;
  const int lk = warp * 16 + g;    // the thread's keys lk, lk + 8
  const int mq = (warp & 3) * 16;  // the warp's dq rows
  const int nc = wgi * NC;         // the warpgroup's dq columns
  // the queries [seen_lo, seen_hi) that see each of the thread's keys: a
  // pair's mask is one interval test on the query's position
  int seen_lo[2], seen_hi[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    key_queries(cu_q, cu_k, s.nseg, s.tq, kend, k0 + lk + half * 8,
                s.causal, s.window, seen_lo + half, seen_hi + half);
  // the warpgroup's K and V rows (A of S^T and dP^T), and K's columns of
  // its dq half (B of dQ)
  const uint32_t ka = smem_u32(ks) + wgi * 8 * kRow8;
  const uint32_t va = smem_u32(vs) + wgi * 8 * kRow8;
  const uint32_t kb = smem_u32(ks) + wgi * (NC / 8) * 128;
  const uint32_t sa = smem_u32(dst);
  int pending = 0, pending_val = 0;

  for (int t = 0; cur.i >= 0; ++t) {
    const int st = t % 3;
    const int q0 = cur.i * kTile;
    const int head = kvh * grp + cur.g;
    cp_async_wait<1>();    // lse, delta (and K, V) of this step
    fence_async_shared();  // K and V are read by wgmma (async proxy)
    // this stage has landed, and both warpgroups are done with the last
    // step (their wgmma reads of its stage, of dS^T and of the staging):
    // only now may step t + 2's copy overwrite that stage
    __syncthreads();
    if (nx2.i >= 0) load_step(nx2, (t + 2) % 3);
    cp_async_commit();  // one group a step, empty or not
    mbar_wait(full + st, (t / 3) & 1);  // this step's Q and dO boxes
    const uint32_t qa = smem_u32(qs + st * kTile * D);
    const uint32_t da = smem_u32(dos + st * kTile * D);
    const float* lt = ls + st * kTile;
    const float* dlt = dls + st * kTile;
    // the thread's keys see the tile's columns [c_lo[h], c_lo[h] + c_n[h])
    // (all 64 when every pair of the half is live)
    const bool all_live = (wgi ? cur.st1 : cur.st0) == kFull;
    unsigned c_lo[2], c_n[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c_lo[h] = all_live ? 0u : static_cast<unsigned>(seen_lo[h] - q0);
      c_n[h] = all_live ? kTile
                        : static_cast<unsigned>(seen_hi[h] - seen_lo[h]);
    }

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
      wg::ss<kTile, 0, 0>(&sc[0][0], wg::desc(ka + kk * 256, 128, kRow8),
                          wg::desc_sw128(qa + kk / 4 * 8192 + kk % 4 * 32, 16,
                                         1024), 1);
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::ss<kTile, 0, 0>(&dp[0][0], wg::desc(va + kk * 256, 128, kRow8),
                          wg::desc_sw128(da + kk / 4 * 8192 + kk % 4 * 32, 16,
                                         1024), 1);
    wg::commit();
    wg::wait<1>();
    wg::fence_regs<4 * kNtS>(&sc[0][0]);

    // P^T in sc (dead pairs 0 by a select, without a branch), then dV +=
    // P^T dO (P^T rounded to bf16, A from registers; B MN-major: rows are
    // the queries), in flight while dS^T is formed
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned c = nt * 8 + tig * 2 + (e & 1);
        const float p = exp2_ftz(fmaf(sc[nt][e], scale_log2, nl[nt][e & 1]));
        sc[nt][e] = c - c_lo[e >> 1] < c_n[e >> 1] ? p : 0.f;
      }
    uint32_t ap[kTile / 16][4], ads[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) pack_a(ap[kk], sc, kk);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wg::rs<D, 1>(&adv[0][0], ap[kk],
                   wg::desc_sw128(da + kk * 2048, 8192, 1024), 1);
    wg::commit();
    wg::wait<1>();
    wg::fence_regs<4 * kNtS>(&dp[0][0]);

    // dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q (dS^T rounded to
    // bf16)
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = sc[nt][e] * (dp[nt][e] - dl[nt][e & 1]) * s.scale;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) pack_a(ads[kk], dp, kk);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wg::rs<D, 1>(&adk[0][0], ads[kk],
                   wg::desc_sw128(qa + kk * 2048, 8192, 1024), 1);
    wg::commit();

    // dS^T (bf16) into its blocked tile, rows the keys
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(
            dst + wg::chunk_offset<kTile>(lk + half * 8, nt) + tig * 4) =
            ads[nt >> 1][(nt & 1) * 2 + half];
    fence_async_shared();
    // the previous step's bulk op has had this step's products to land
    release_dq(sync, &pending, pending_val);
    __syncthreads();  // dS^T is complete

    // dQ_partial = dS K: the tile's 64 queries x the warpgroup's NC
    // columns (A = dS^T, B = K, both MN-major: rows are the keys)
    float dqa[kNtQ][4];
#pragma unroll
    for (int nd = 0; nd < kNtQ; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wg::ss<NC, 1, 1>(&dqa[0][0],
                          wg::desc(sa + kk * 2 * (16 * kTile), 16 * kTile,
                                   128),
                          wg::desc(kb + kk * 2 * kRow8, kRow8, 128), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs<4 * kNtO>(&adv[0][0]);
    wg::fence_regs<4 * kNtO>(&adk[0][0]);
    wg::fence_regs<4 * kNtQ>(&dqa[0][0]);

    // this key tile's add into (head, query tile i), after its predecessor
    add_dq<D, NC>(dqa, cur.prev < 0, cur.last, sync,
                  1 + head * nq + cur.i, cur.prev + 1, j + 1, ws, dq, q0,
                  s.h, head, s.tq - q0, mq, nc, stg, &pending, &pending_val);
    cur = nx1;
    nx1 = nx2;
    nx2 = advance(nx2);
  }
  release_dq(sync, &pending, pending_val);
  cp_async_wait<0>();  // a CTA without steps still has K and V in flight
  store_rows<D>(dk + kv_off, kv_stride, adk, k0 + lk, s.tk, tig);
  store_rows<D>(dv + kv_off, kv_stride, adv, k0 + lk, s.tk, tig);

  // dq = 0 on the query tiles that hold no live pair (padding, rows that
  // see no key), which no key tile adds to: each CTA takes the tiles whose
  // index is its ticket modulo the grid (rows q0 .. q0 + 63 of every head
  // are one contiguous block)
  for (int i = ticket; i < nq; i += gridDim.x) {
    const int q0 = i * kTile;
    if (runs_live(cu_q, cu_k, s.nseg, q0, min(q0 + kTile, qend), 0, kend,
                  s.causal, s.window))
      continue;
    uint4* o = reinterpret_cast<uint4*>(dq + q0 * q_stride);
    const int n =
        (min(q0 + kTile, s.tq) - q0) * static_cast<int>(q_stride) / 8;
    for (int e = threadIdx.x; e < n; e += kThreads)
      o[e] = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------- K8 f32
// K8's walk and dq order in f32 on bwd_f32.cuh's 3xTF32 tile math: one CTA
// per (KV head, BK-key tile) (BK = 64 at D = 64, 128 at D = 128, as K8),
// BK / 16 warps of 16 keys, the 64-key half of warp w is w / 4; K and V
// resident, Q (with lse and delta) and dO one step at a time. The walk is
// K8's: chunks of up to one live query tile a thread, found in parallel.
template <int D>
using F32 = bwd32::Shape<D>;
// cu_seqlens entries in shared memory (2 KB), so that three 64-key CTAs
// share an SM at D = 64
constexpr int kCuSmemF32 = 256;

// One step of the f32 walk: query tile i (-1 once the walk is over), head
// g of the group, the tile's state against each 64-key half, and the key
// tile of its previous contributor (-1: this one is the first).
struct StepF32 {
  int i, g, st0, st1, prev;
};

template <int D>
__global__ void __launch_bounds__(F32<D>::kThreads, D == 64 ? 3 : 1)
    varlen_bwd_fused_f32_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const int* __restrict__ cu_q_g,
                                const int* __restrict__ cu_k_g,
                                float* __restrict__ dq,
                                float* __restrict__ dk,
                                float* __restrict__ dv,
                                int* __restrict__ sync, Seg s) {
  using M = F32<D>;
  constexpr int BK = M::BK;
  constexpr int W = BK / kTile;  // 64-key halves
  constexpr int kThreads = M::kThreads;
  constexpr int kWarps = M::kWarps;
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f + M::k_off;
  float* vs = smem_f + M::v_off;
  float* qs = smem_f + M::q_off;
  float* dos = smem_f + M::do_off;  // dO, then dS^T
  float* ls = smem_f + M::lse_off;
  float* dls = smem_f + M::delta_off;
  __shared__ int ticket;
  __shared__ Walk walks[W];
  __shared__ int wl_warp[kWarps];
  __shared__ int wl_i[kThreads], wl_prev[kThreads], wl_flags[kThreads];
  __shared__ int cu_s[2 * kCuSmemF32];

  // the work item: ticket = j * hk + kv_head; cu_seqlens into shared memory
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  const bool cu_shared = s.nseg < kCuSmemF32;
  if (cu_shared)
    for (int i = threadIdx.x; i <= s.nseg; i += kThreads) {
      cu_s[i] = cu_q_g[i];
      cu_s[kCuSmemF32 + i] = cu_k_g[i];
    }
  const int* cu_q = cu_shared ? cu_s : cu_q_g;
  const int* cu_k = cu_shared ? cu_s + kCuSmemF32 : cu_k_g;
  __syncthreads();
  const int j = ticket / s.hk;
  const int kvh = ticket % s.hk;
  const int k0 = j * BK;
  const int grp = s.h / s.hk;
  const int nq = (s.tq + kTile - 1) / kTile;
  const int qend = min(s.tq, cu_q[s.nseg]);
  const int kend = min(s.tk, cu_k[s.nseg]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half_of = warp >> 2;  // the warp's 64-key half
  const int lk = warp * 16 + (lane >> 2);  // the thread's keys lk, lk + 8
  const int mq = (warp & 3) * 16;          // the warp's dq rows
  const int nc = (warp >> 2) * M::NC;      // and columns
  const size_t kv_stride = static_cast<size_t>(s.hk) * D;
  const size_t kv_off = static_cast<size_t>(kvh) * D;
  const size_t q_stride = static_cast<size_t>(s.h) * D;

  bwd32::load_rows_f32<D, BK, kThreads>(ks, k + kv_off, kv_stride, k0, kend);
  bwd32::load_rows_f32<D, BK, kThreads>(vs, v + kv_off, kv_stride, k0, kend);
  // each half's walk and query range (as K8)
  int lo = s.tq, hi = 0;
  for (int w = 0; w < W; ++w) {
    int rlo, rhi;
    const Walk wk = query_walk(cu_q, cu_k, s.nseg, s.tq, kend,
                               k0 + w * kTile, s.causal, s.window, &rlo,
                               &rhi);
    if (threadIdx.x == w) walks[w] = wk;
    if (rlo < rhi) {
      lo = min(lo, rlo);
      hi = max(hi, rhi);
    }
  }
  hi = min(hi, qend);
  const int ilo = lo / kTile;

  auto half_state = [&](int w, int q0) -> int {
    if (walks[w].one_seg) return walks[w].state(q0);
    const int kw = k0 + w * kTile;
    return runs_live(cu_q, cu_k, s.nseg, q0, min(q0 + kTile, qend), kw,
                     min(kw + kTile, kend), s.causal, s.window)
               ? kPartial
               : kDead;
  };
  // the previous live contributor of live query tile i below this CTA's
  // key tile (-1: none)
  auto prev_of = [&](int i) -> int {
    const int q0 = i * kTile;
    const int q1 = min(q0 + kTile, qend);
    int sf, rf, sl, rl, klo, khi;
    query_row(cu_q, cu_k, s.nseg, s.tq, q0, &sf, &rf);
    query_row(cu_q, cu_k, s.nseg, s.tq, q1 - 1, &sl, &rl);
    key_range_of(cu_k, s.tk, sf, rf, sl, rl, s.causal, s.window, &klo, &khi);
    for (int jj = j - 1; jj >= klo / BK; --jj)
      if (runs_live(cu_q, cu_k, s.nseg, q0, q1, jj * BK,
                    min(jj * BK + BK, kend), s.causal, s.window))
        return jj;
    return -1;
  };
  int wl_top = hi > lo ? (hi - 1) / kTile : ilo - 1;
  int wl_pos = 0, wl_len = 0;
  auto fill = [&]() {
    __syncthreads();  // every thread is done with the last chunk
    const int i = wl_top - static_cast<int>(threadIdx.x);
    int st0 = kDead, st1 = kDead, prev = -1;
    if (i >= ilo) {
      st0 = half_state(0, i * kTile);
      if constexpr (W > 1) st1 = half_state(1, i * kTile);
      if (st0 != kDead || st1 != kDead) prev = prev_of(i);
    }
    const bool live = st0 != kDead || st1 != kDead;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) wl_warp[warp] = __popc(ballot);
    __syncthreads();
    int at = __popc(ballot & ((1u << lane) - 1)), total = 0;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? wl_warp[w] : 0;
      total += wl_warp[w];
    }
    if (live) {
      wl_i[at] = i;
      wl_prev[at] = prev;
      wl_flags[at] = st0 | st1 << 2;
    }
    __syncthreads();
    wl_top -= kThreads;
    wl_pos = 0;
    wl_len = total;
  };
  auto advance = [&](StepF32 c) -> StepF32 {
    if (c.i < 0 || ++c.g < grp) return c;
    c.g = 0;
    while (wl_pos == wl_len) {
      if (wl_top < ilo) {
        c.i = -1;
        return c;
      }
      fill();
    }
    c.i = wl_i[wl_pos];
    c.prev = wl_prev[wl_pos];
    const int f = wl_flags[wl_pos++];
    c.st0 = f & 3;
    c.st1 = (f >> 2) & 3;
    return c;
  };
  // step c's Q, lse and delta; its dO
  auto load_q = [&](const StepF32& c) {
    const int q0 = c.i * kTile;
    const int head = kvh * grp + c.g;
    bwd32::load_rows_f32<D, kTile, kThreads>(
        qs, q + static_cast<size_t>(head) * D, q_stride, q0, s.tq);
    const size_t row0 = static_cast<size_t>(head) * s.tq;
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool ok = q0 + r < s.tq;
      cp_async4(ls + r, lse + (ok ? row0 + q0 + r : 0), ok);
      cp_async4(dls + r, delta + (ok ? row0 + q0 + r : 0), ok);
    }
  };
  auto load_do = [&](const StepF32& c) {
    bwd32::load_rows_f32<D, kTile, kThreads>(
        dos, dout + static_cast<size_t>(kvh * grp + c.g) * D, q_stride,
        c.i * kTile, s.tq);
  };

  StepF32 cur{0, grp - 1, 0, 0, -1};
  cur = advance(cur);
  StepF32 nxt = advance(cur);
  if (cur.i >= 0) load_q(cur);
  cp_async_commit();

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;
  // the queries [seen_lo, seen_hi) that see each of the thread's keys
  int seen_lo[2], seen_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_queries(cu_q, cu_k, s.nseg, s.tq, kend, k0 + lk + h * 8, s.causal,
                s.window, seen_lo + h, seen_hi + h);
  int* pending = nullptr;  // thread 0: the counter of an add in flight
  const int pending_val = j + 1;

  while (cur.i >= 0) {
    const int q0 = cur.i * kTile;
    const int head = kvh * grp + cur.g;
    // the thread's keys see the tile's columns [c_lo[h], c_lo[h] + c_n[h])
    // (all 64 when every pair of the half is live)
    const bool all_live = (half_of ? cur.st1 : cur.st0) == kFull;
    unsigned c_lo[2], c_n[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c_lo[h] = all_live ? 0u : static_cast<unsigned>(seen_lo[h] - q0);
      c_n[h] = all_live ? kTile
                        : static_cast<unsigned>(seen_hi[h] - seen_lo[h]);
    }
    cp_async_wait<0>();  // Q, lse, delta (and K, V) of this step
    bwd32::bulk_wait_read();  // the last dq add has read its staging
    __syncthreads();
    load_do(cur);  // into the dO tile, while S^T runs
    cp_async_commit();

    float sc[kTile / 8][4], dp[kTile / 8][4];
    bwd32::rows_by_rows<D>(ks, warp * 16, qs, sc);  // S^T = K Q^T
    bwd32::probs(sc, ls, s.scale, [&](int c, int h) {
      return static_cast<unsigned>(c) - c_lo[h] < c_n[h];
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
    if (nxt.i >= 0) load_q(nxt);
    cp_async_commit();
    bwd32::store_dst(dos, warp * 16, dp);
    __syncthreads();  // dS^T is complete
    float dqa[8][4];
    bwd32::dq_partial<D>(dos, ks, mq, nc, dqa);  // dQ = dS K
    __syncthreads();  // every warp is done with dS^T: the staging is free

    // this key tile's add into (head, query tile i), after its predecessor
    int* counter = sync + 1 + head * nq + cur.i;
    bwd32::add_dq_f32<D>(dqa, cur.prev < 0, counter, cur.prev + 1,
                         dq + q0 * q_stride + static_cast<size_t>(head) * D,
                         q_stride, s.tq - q0, mq, nc, dos);
    pending = counter;
    cur = nxt;
    nxt = advance(nxt);
  }
  bwd32::release_dq_f32(&pending, pending_val);
  cp_async_wait<0>();  // a CTA without steps still has K and V in flight
  bwd32::store_rows_f32<D>(dk + kv_off, kv_stride, adk, k0 + warp * 16, s.tk);
  bwd32::store_rows_f32<D>(dv + kv_off, kv_stride, adv, k0 + warp * 16, s.tk);

  // dq = 0 on the query tiles that hold no live pair, which no key tile
  // adds to (as K8)
  for (int i = ticket; i < nq; i += gridDim.x) {
    const int q0 = i * kTile;
    if (runs_live(cu_q, cu_k, s.nseg, q0, min(q0 + kTile, qend), 0, kend,
                  s.causal, s.window))
      continue;
    float4* o = reinterpret_cast<float4*>(dq + q0 * q_stride);
    const int n =
        (min(q0 + kTile, s.tq) - q0) * static_cast<int>(q_stride) / 4;
    for (int e = threadIdx.x; e < n; e += kThreads)
      o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ------------------------------------------------------------- launch
bool valid(int nseg, int h, int hk, int d, int causal, int window) {
  return nseg > 0 && hk > 0 && h % hk == 0 && (d == 64 || d == 128) &&
         window >= 0 && (window == 0 || causal);
}

template <int D>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* cu_q, const int* cu_k, void* dq, void* dk,
                 void* dv, float* ws, int* sync, const Seg& s, int items,
                 cudaStream_t st) {
  static bool configured = false;
  CUtensorMap qmap, dmap;
  if (int e = make_map(&qmap, q, 1, s.tq, s.h, D)) return e;
  if (int e = make_map(&dmap, dout, 1, s.tq, s.h, D)) return e;
  constexpr size_t bytes = FusedSmem<D>::bytes;
  if (int e = set_smem(varlen_bwd_fused_kernel<D>, bytes, &configured))
    return e;
  varlen_bwd_fused_kernel<D><<<items, Shape<D>::kThreads, bytes, st>>>(
      qmap, dmap, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lse, delta, cu_q, cu_k, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), ws, sync, s);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fused_f32(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* cu_q, const int* cu_k, void* dq, void* dk,
                     void* dv, int* sync, const Seg& s, int items,
                     cudaStream_t st) {
  static bool configured = false;
  constexpr size_t bytes = F32<D>::bytes;
  if (int e = set_smem(varlen_bwd_fused_f32_kernel<D>, bytes, &configured))
    return e;
  varlen_bwd_fused_f32_kernel<D><<<items, F32<D>::kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, cu_q, cu_k, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), sync, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8. q, do, dq (Tq, H, D); k, v, dk, dv (Tk, HK, D); lse, delta (H, Tq)
// f32; cu_q, cu_k (nseg + 1,) int32; all contiguous, of one dtype (bf16 or
// f32) but lse, delta and the cu_seqlens. D is 64 or 128; window 0 means
// none (needs causal). counters are 1 + H * ceil(Tq / 64) int32 zeros (the
// ticket, then one counter per (head, query tile)); dk, dv are each KV
// head's sum over the query heads of its group. bf16: dq_ws is the f32
// workspace (H, ceil(Tq / 64), 64, D + 4); f32: dq takes the adds itself
// (dq_ws unused).
extern "C" int ptt_varlen_flash_attention_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cu_q, const void* cu_k,
    void* dq, void* dk, void* dv, void* dq_ws, void* counters, int tq,
    int tk, int nseg, int h, int hk, int d, int causal, int window,
    float sm_scale, int dtype, void* stream) {
  if (tq <= 0 || tk <= 0) return 0;
  const bool f32 = dtype == kF32;
  const int bk = d == 64 ? Shape<64>::BK : Shape<128>::BK;
  const long long items = static_cast<long long>((tk + bk - 1) / bk) * hk;
  if ((dtype != kBF16 && !f32) || !valid(nseg, h, hk, d, causal, window) ||
      items > 0x7fffffffLL || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv) || (!f32 && !aligned16(dq_ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seg s{tq, tk, nseg, h, hk, causal, window, sm_scale};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* cq = static_cast<const int*>(cu_q);
  const int* ck = static_cast<const int*>(cu_k);
  float* ws = static_cast<float*>(dq_ws);
  int* sync = static_cast<int*>(counters);
  const int n = static_cast<int>(items);
  if (f32)
    return d == 64 ? launch_fused_f32<64>(q, k, v, dout, l, dl, cq, ck, dq,
                                          dk, dv, sync, s, n, st)
                   : launch_fused_f32<128>(q, k, v, dout, l, dl, cq, ck, dq,
                                           dk, dv, sync, s, n, st);
  return d == 64 ? launch_fused<64>(q, k, v, dout, l, dl, cq, ck, dq, dk,
                                    dv, ws, sync, s, n, st)
                 : launch_fused<128>(q, k, v, dout, l, dl, cq, ck, dq, dk,
                                     dv, ws, sync, s, n, st);
}
