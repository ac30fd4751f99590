// Varlen (packed) flash attention backward for Hopper: K8, one fused bf16
// kernel for dq, dk and dv, and K8a (dq) / K8b (dk, dv) in f32.
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
// The f32 kernels K8a / K8b (the parity route) are CUDA-core FMA in the
// tile shape of flash_f32.cuh (256 threads, each a 4 x 4 micro-tile of
// scores and a 4 x D/16 slice of the output): K8a a CTA per 64-row query
// tile walking its key range, K8b a CTA per 64-key tile walking its query
// range over the G heads of its group, both in the heaviest-first order of
// varlen_seg.cuh's tile-order kernel, dead tiles skipped by their indices.
#include "bwd_fused.cuh"
#include "common.cuh"
#include "flash_f32.cuh"
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

static_assert(fl::kBQ == kTile && flash_f32::kBQ == kTile &&
                  flash_f32::kBK == kTile,
              "K8 shares the 64-row tiles of flash_mma.cuh, flash_f32.cuh "
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

}  // namespace

// K8. q, do, dq (Tq, H, D); k, v, dk, dv (Tk, HK, D); lse, delta (H, Tq)
// f32; cu_q, cu_k (nseg + 1,) int32; all contiguous bf16 but lse, delta
// and the cu_seqlens. D is 64 or 128; window 0 means none (needs causal).
// dq_ws is the f32 workspace (H, ceil(Tq / 64), 64, D + 4) and counters 1
// + H * ceil(Tq / 64) int32 zeros (the ticket, then one counter per (head,
// query tile)); dk, dv are each KV head's sum over the query heads of its
// group.
extern "C" int ptt_varlen_flash_attention_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cu_q, const void* cu_k,
    void* dq, void* dk, void* dv, void* dq_ws, void* counters, int tq,
    int tk, int nseg, int h, int hk, int d, int causal, int window,
    float sm_scale, int dtype, void* stream) {
  if (tq <= 0 || tk <= 0) return 0;
  const int bk = d == 64 ? Shape<64>::BK : Shape<128>::BK;
  const long long items = static_cast<long long>((tk + bk - 1) / bk) * hk;
  if (dtype != kBF16 || !valid(nseg, h, hk, d, causal, window) ||
      items > 0x7fffffffLL || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv) || !aligned16(dq_ws))
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
  return d == 64 ? launch_fused<64>(q, k, v, dout, l, dl, cq, ck, dq, dk,
                                    dv, ws, sync, s, n, st)
                 : launch_fused<128>(q, k, v, dout, l, dl, cq, ck, dq, dk,
                                     dv, ws, sync, s, n, st);
}

// K8a, f32: dq from q, k, v, do, lse, delta as above; order is int32
// scratch of ceil(Tq / 64).
extern "C" int ptt_varlen_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cu_q, const void* cu_k,
    void* order, void* dq, int tq, int tk, int nseg, int h, int hk, int d,
    int causal, int window, float sm_scale, int dtype, void* stream) {
  if (tq <= 0) return 0;
  const int ntiles = (tq + kTile - 1) / kTile;
  if (tk < 0 || ntiles > 65535 || dtype != kF32 ||
      !valid(nseg, h, hk, d, causal, window) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seg s{tq, tk, nseg, h, hk, causal, window, sm_scale};
  const int* cq = static_cast<const int*>(cu_q);
  const int* ck = static_cast<const int*>(cu_k);
  int* ord = static_cast<int*>(order);
  if (int e = launch_tile_order(cq, ck, s, 0, ntiles, ord, st)) return e;
  static bool configured = false;
  if (int e = set_smem(varlen_bwd_dq_f32_kernel, kDqSmemF32, &configured))
    return e;
  varlen_bwd_dq_f32_kernel<<<dim3(h, ntiles), flash_f32::kThreads,
                             kDqSmemF32, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), cq,
      ck, ord, static_cast<float*>(dq), s, d);
  return static_cast<int>(cudaGetLastError());
}

// K8b, f32: dk, dv (Tk, HK, D), each KV head's sum over the query heads of
// its group; order is int32 scratch of ceil(Tk / 64).
extern "C" int ptt_varlen_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cu_q, const void* cu_k,
    void* order, void* dk, void* dv, int tq, int tk, int nseg, int h, int hk,
    int d, int causal, int window, float sm_scale, int dtype, void* stream) {
  if (tk <= 0) return 0;
  const int ntiles = (tk + kTile - 1) / kTile;
  if (tq < 0 || ntiles > 65535 || dtype != kF32 ||
      !valid(nseg, h, hk, d, causal, window) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dk) ||
      !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seg s{tq, tk, nseg, h, hk, causal, window, sm_scale};
  const int* cq = static_cast<const int*>(cu_q);
  const int* ck = static_cast<const int*>(cu_k);
  int* ord = static_cast<int*>(order);
  if (int e = launch_tile_order(cq, ck, s, 1, ntiles, ord, st)) return e;
  static bool configured = false;
  if (int e = set_smem(varlen_bwd_dkv_f32_kernel, kDkvSmemF32, &configured))
    return e;
  varlen_bwd_dkv_f32_kernel<<<dim3(hk, ntiles), flash_f32::kThreads,
                              kDkvSmemF32, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), cq,
      ck, ord, static_cast<float*>(dk), static_cast<float*>(dv), s, d);
  return static_cast<int>(cudaGetLastError());
}
