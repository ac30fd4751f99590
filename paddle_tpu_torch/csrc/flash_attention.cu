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
// Design of the bf16 kernel (`flash_fwd_wgmma_kernel`). The tile plan is
// stated once in Python (ops/flash_attention.py `FwdTiles`, rehearsed on
// the CPU by tests/test_torch_flash_fwd_tiles.py) and followed here:
// - One CTA per (128-row query tile, head, batch), 256 threads: two
//   warpgroups, each owning 64 of the rows. The CTA derives from indices
//   alone the contiguous key range its rows can see (the causal diagonal
//   of its last row, the window edge of its first row: `_kv_band_clamp`,
//   flash_mma.cuh `key_range` at 128 rows) and walks only that range in
//   128-key tiles, so no byte of a dead tile is read. Tiles wholly inside
//   the band skip the mask (`_run_full`'s `full`, `full_tile` at 128 x
//   128).
// - Launch order (a 1-D grid): the query tiles by their live keys, most
//   first, and within one tile every (batch, head) with the heads fastest,
//   so the query heads of one KV head run side by side and share its K / V
//   tiles through L2. Only the last (ragged) query tile can have fewer
//   live keys than a lower one; `tile_of_rank` finds its place.
// - Copies by TMA (tma.cuh), issued by one thread: the Q tile once, the K
//   and V tiles into a ring of stages behind mbarriers (expect_tx), all in
//   64 x 64 boxes with the 128-byte swizzle that wgmma reads. A stage is
//   refilled by whichever warpgroup finishes with it last (a turn counter
//   in shared memory), so neither waits for the other.
// - Products on `wgmma` (wgmma.cuh), f32 accumulators: S = Q K^T from
//   shared memory (both K-major: D is contiguous in Q and K), the online
//   softmax on the accumulator (mma.sync's m16n8 layout per warp; exp2 in
//   one MUFU instruction), P rounded to bf16 and re-packed as a register
//   A operand (the TPU kernel rounds P to v's dtype; the row sum l uses the
//   unrounded P), O += P V with V MN-major (keys are the reduction axis, D
//   contiguous: the `trans` flag).
// - Overlap, two kinds: within a warpgroup, tile t's S is issued together
//   with tile t - 1's P V, so the softmax of tile t runs while the tensor
//   cores take P V of tile t - 1; between the two warpgroups, named
//   barriers hand the tensor cores from one to the other in turn
//   (ping-pong), so one's softmax runs under the other's products. Each
//   took time off at the training and Mistral shapes; a third ring stage
//   at D = 128 did not (PERF.md §6). Warpgroup 1 of a last query tile of
//   at most 64 rows holds no real row: it computes nothing and only keeps
//   its turns (the stages' and the cores').
// - f32 (`flash_fwd_f32_kernel`): flash_f32.cuh's tile loop, shared with
//   K3: both products on the tensor cores as 3xTF32 (mma.sync m16n8k8, f32
//   results), 64-row query tiles on 4 warps, one CTA per (query tile,
//   batch, head) in a 1-D grid, the tiles with the most live keys first
//   and the heads of one KV head side by side.
#include "common.cuh"
#include "flash_f32.cuh"
#include "flash_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

using namespace ptt;
using namespace ptt::flash;

namespace {

static_assert(kBQ == flash_f32::kBQ && kBK == flash_f32::kBK,
              "the f32 path uses flash_f32.cuh's tiles");
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- bf16
constexpr int kTQ = 128;  // query rows per CTA: two warpgroups of 64
constexpr int kTK = 128;  // keys per tile
constexpr int kThreadsWG = 256;
constexpr int kBox = 64 * 128;   // bytes of one TMA box (64 rows x 128 B)
constexpr int kCol = 2 * kBox;   // one 64-column slice of a 128-row tile

// Byte offsets of the shared memory at head width D: the Q tile, then
// the rings of K and V tiles (two stages at D = 128, 160 KB in all; three
// at D = 64); every tile is D / 64 slices of 128 rows x 128 bytes (two
// TMA boxes each), in the 128-byte swizzle.
template <int D>
struct FwdSmem {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr size_t tile = sizeof(bf16) * kTK * D;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + tile;               // [kStages]
  static constexpr size_t v = k + kStages * tile;     // [kStages]
  // the barriers: q, then K's and V's full[kStages]
  static constexpr size_t bars = v + kStages * tile;
  static constexpr size_t turns = bars + sizeof(uint64_t) * (1 + 2 * kStages);
  // K's and V's turn counters, and 1 KB of room to align the base to the
  // swizzle's 1024-byte atoms
  static constexpr size_t bytes = turns + sizeof(int) * 2 * kStages + 1024;
  static_assert(tile % 1024 == 0, "TMA boxes land on 1024-byte atoms");
};

// The live keys of query tile i (its key range's length) and the range's
// start.
__device__ __forceinline__ int tile_keys(const Dims& s, int i, int* lo) {
  int hi;
  key_range<kTQ>(s, i * kTQ, lo, &hi);
  return max(hi - *lo, 0);
}

// The query tile of launch rank r: tiles by live keys, most first, ties
// to the higher tile (FwdTiles.tile_of_rank). Below the last tile the
// count never falls as the tile rises (each key range's two ends move up
// with the rows, the start no faster than the end), so the order is the
// tiles from the top down with the last one moved behind the tiles that
// see more keys than it does.
__device__ __forceinline__ int tile_of_rank(const Dims& s, int nq, int r) {
  int lo;
  const int last = tile_keys(s, nq - 1, &lo);
  int p = 0;  // the tiles below the last that see more keys
  while (p < nq - 1 && tile_keys(s, nq - 2 - p, &lo) > last) ++p;
  return r < p ? nq - 2 - r : (r == p ? nq - 1 : nq - 1 - r);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreadsWG, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           Dims s, int nb) {
  using M = FwdSmem<D>;
  constexpr int S = M::kStages;
  constexpr int kNtS = kTK / 8;  // score n-tiles (8 keys)
  constexpr int kNtO = D / 8;    // output n-tiles
  constexpr int kKs = kTK / 16;  // k16 steps of P V
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  unsigned char* sm =
      smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + M::bars);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + S;
  int* kturn = reinterpret_cast<int*>(sm + M::turns);
  int* vturn = kturn + S;

  const int nq = (s.sq + kTQ - 1) / kTQ;
  const int bh = blockIdx.x % (nb * s.h);
  const int i = tile_of_rank(s, nq, blockIdx.x / (nb * s.h));
  const int b = bh / s.h;
  const int head = bh % s.h;
  const int kvh = head / (s.h / s.hk);
  const int q0 = i * kTQ;
  int lo, hi;
  key_range<kTQ>(s, q0, &lo, &hi);
  const int n = hi > lo ? (hi - lo + kTK - 1) / kTK : 0;

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;  // the warpgroup: rows 64 wgi .. 64 wgi + 63
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  // warpgroup 1 of a last tile of at most 64 rows holds no real row
  const bool busy = q0 + wgi * 64 < s.sq;

  // tile t of K or V (`map`) into stage st of its ring (one thread)
  auto load = [&](const CUtensorMap* map, size_t ring, uint64_t* full, int t,
                  int st) {
    const int k0 = lo + t * kTK;
    mbar_expect_tx(full + st, M::tile);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        tma_box(sm + ring + st * M::tile + c * kCol + rh * kBox, map, c * 64,
                kvh, k0 + rh * 64, b, full + st);
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(kfull + st, 1);
      mbar_init(vfull + st, 1);
      kturn[st] = vturn[st] = 0;
    }
    mbar_fence_init();
    if (n > 0) {
      mbar_expect_tx(qbar, M::tile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          tma_box(sm + M::q + c * kCol + rh * kBox, &qmap, c * 64, head,
                  q0 + rh * 64, b, qbar);
      for (int t = 0; t < S && t < n; ++t) {
        load(&kmap, M::k, kfull, t, t);
        load(&vmap, M::v, vfull, t, t);
      }
    }
  }
  __syncthreads();

  // the warpgroup is done reading tile t of K (S done) or of V (P V
  // done): the second of the two warpgroups to finish refills the stage
  // with tile t + S
  auto release = [&](const CUtensorMap* map, size_t ring, uint64_t* full,
                     int* turn, int t) {
    if (t + S < n && (tid & 127) == 0) {
      __threadfence_block();
      if (atomicAdd(turn + t % S, 1) & 1) {
        __threadfence_block();
        load(map, ring, full, t + S, t % S);
      }
    }
  };

  float o[kNtO][4];
#pragma unroll
  for (int j = 0; j < kNtO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float sc[kNtS][4];    // the scores of the tile in hand, then its P
  uint32_t ap[kKs][4];  // P (bf16) of the tile whose P V is next
  float m[2] = {kNegInf, kNegInf};  // running max of scaled scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  const float scale_log2 = s.scale * kLog2e;
  const int r0 = q0 + wgi * 64 + warp * 16 + g;  // rows r0, r0 + 8
  const uint32_t qa = smem_u32(sm + M::q) + wgi * kBox;
  const uint32_t ka = smem_u32(sm + M::k);
  const uint32_t va = smem_u32(sm + M::v);

  // Every product is issued on a path that all its warpgroup takes, after
  // a fence that every register it reads is defined before (fence_regs):
  // ptxas would otherwise add fences of its own and serialize them.
  // S = Q K^T over tile t of K: the warpgroup's 64 rows x 128 keys
  auto issue_s = [&](int t) {
    const uint32_t kt = ka + (t % S) * M::tile;
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    wg::fence_regs<4 * kNtS>(&sc[0][0]);
    wg::fence_regs<4 * kNtO>(&o[0][0]);
    wg::fence_regs<4 * kKs>(&ap[0][0]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::ss<kTK, 0, 0>(
          &sc[0][0], wg::desc_sw128(qa + kk / 4 * kCol + kk % 4 * 32, 16, 1024),
          wg::desc_sw128(kt + kk / 4 * kCol + kk % 4 * 32, 16, 1024), 1);
    wg::commit();
  };
  // O += P V over tile t of V (A: P from registers; B: V, MN-major)
  auto issue_pv = [&](int t) {
    const uint32_t vt = va + (t % S) * M::tile;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk)
      wg::rs<D, 1>(&o[0][0], ap[kk],
                   wg::desc_sw128(vt + kk * 2048, kCol, 1024), 1);
    wg::commit();
  };
  // mask, online softmax and P of tile t's scores (in sc), the rescale of
  // O (which no product may be writing)
  auto softmax = [&](int t, float* alpha) {
    const int k0 = lo + t * kTK;
    // mask (boundary tiles only): dead pairs to -inf, which exp sends to 0
    if (!full_tile<kTQ, kTK>(s, q0, k0)) {
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + (e >> 1) * 8;
          const int c = k0 + nt * 8 + tig * 2 + (e & 1);
          if (!band_live(s, r, c)) sc[nt][e] = -INFINITY;
        }
    }
    // rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3); the four threads of a
    // quad share a row
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * half], sc[nt][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx * s.scale);
      alpha[half] = exp2_ftz((m[half] - m_new) * kLog2e);
      const float ml = m_new * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float p = exp2_ftz(fmaf(sc[nt][e], scale_log2, -ml));
          sc[nt][e] = p;
          rs += p;
        }
      l[half] = alpha[half] * l[half] + rs;
      m[half] = m_new;
    }
  };
  // O *= alpha, then P (bf16) straight from the score fragments
  auto rescale_pack = [&](const float* alpha) {
#pragma unroll
    for (int nd = 0; nd < kNtO; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) pack_a(ap[kk], sc, kk);
  };
  auto wait_k = [&](int t) { mbar_wait(kfull + t % S, (t / S) & 1); };
  auto wait_v = [&](int t) { mbar_wait(vfull + t % S, (t / S) & 1); };

  if (!busy) {
    // no real row: compute nothing, free each stage in its turn (and keep
    // the turns of the cores with warpgroup 0)
    if (n > 0) bar_arrive(1, kThreadsWG);
    for (int t = 0; t < n; ++t) {
      bar_sync(2, kThreadsWG);
      bar_arrive(1, kThreadsWG);
      wait_k(t);
      release(&kmap, M::k, kfull, kturn, t);
      wait_v(t);
      release(&vmap, M::v, vfull, vturn, t);
    }
  } else if (n > 0) {
    float alpha[2];
    mbar_wait(qbar, 0);
    if (wgi == 1) bar_arrive(1, kThreadsWG);  // warpgroup 0 goes first
    // tile 0, then each tile's S issued before the previous tile's P V,
    // so its softmax runs while the tensor cores take P V
    wait_k(0);
    bar_sync(1 + wgi, kThreadsWG);  // this warpgroup's turn on the cores
    issue_s(0);
    bar_arrive(2 - wgi, kThreadsWG);  // the other warpgroup's turn
    wg::wait<0>();
    wg::fence_regs<4 * kNtS>(&sc[0][0]);
    release(&kmap, M::k, kfull, kturn, 0);
    softmax(0, alpha);
    rescale_pack(alpha);
    for (int t = 1; t < n; ++t) {
      wait_k(t);
      wait_v(t - 1);
      bar_sync(1 + wgi, kThreadsWG);
      issue_s(t);
      issue_pv(t - 1);
      bar_arrive(2 - wgi, kThreadsWG);
      wg::wait<1>();
      wg::fence_regs<4 * kNtS>(&sc[0][0]);
      release(&kmap, M::k, kfull, kturn, t);
      softmax(t, alpha);
      wg::wait<0>();
      wg::fence_regs<4 * kNtO>(&o[0][0]);
      release(&vmap, M::v, vfull, vturn, t - 1);
      rescale_pack(alpha);
    }
    wait_v(n - 1);
    wg::fence_regs<4 * kNtO>(&o[0][0]);
    wg::fence_regs<4 * kKs>(&ap[0][0]);
    wg::fence();
    issue_pv(n - 1);
    wg::wait<0>();
    wg::fence_regs<4 * kNtO>(&o[0][0]);
    if (wgi == 0) bar_sync(1, kThreadsWG);  // warpgroup 1's last arrival
  }

  // O / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30))
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = r0 + half * 8;
    if (r < s.sq) {
      const float lc = fmaxf(lt, 1e-30f);
      const float inv = 1.f / lc;
      bf16* dst = out + ((static_cast<size_t>(b) * s.sq + r) * s.h + head) * D +
                  tig * 2;
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
// flash_f32.cuh's 3xTF32 tile loop over the band's key range; every tile
// in the range holds a live pair, so none is skipped, and a tile wholly
// inside the band skips the mask.
struct BandTiles {
  Dims s;
  int q0;

  __device__ int tile(int k0, int) const {
    return full_tile(s, q0, k0) ? flash_f32::kFull : flash_f32::kPartial;
  }
  __device__ bool live(int r, int k0, int c, int) const {
    return band_live(s, q0 + r, k0 + c);
  }
};

// A 1-D grid: item = (rank * B + batch) * H + head, the query tiles by
// their live keys, most first (the last tile down to the first under a
// causal mask), and within one rank every (batch, head) with the heads
// fastest, so the query heads of one KV head run side by side.
template <int D>
__global__ void __launch_bounds__(flash_f32::kThreads, D == 64 ? 3 : 2)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, Dims s, int b) {
  const int head = blockIdx.x % s.h;
  const int rest = blockIdx.x / s.h;
  const int bi = rest % b;
  const int q0 = ((s.sq + kBQ - 1) / kBQ - 1 - rest / b) * kBQ;
  const int kvh = head / (s.h / s.hk);
  extern __shared__ __align__(16) float smem_f32[];

  int lo, hi;
  key_range(s, q0, &lo, &hi);
  BandTiles tiles{s, q0};
  const size_t row = static_cast<size_t>(s.h) * D;
  const size_t kv0 = (static_cast<size_t>(bi) * s.sk * s.hk + kvh) * D;
  flash_f32::attend<D>(
      q + ((static_cast<size_t>(bi) * s.sq + q0) * s.h + head) * D, row,
      min(kBQ, s.sq - q0), k + kv0, v + kv0, static_cast<size_t>(s.hk) * D,
      lo, hi, D, s.scale, tiles,
      out + ((static_cast<size_t>(bi) * s.sq + q0) * s.h + head) * D, row,
      lse + (static_cast<size_t>(bi) * s.h + head) * s.sq + q0, smem_f32);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, const Dims& s, int b, cudaStream_t stream) {
  static bool configured = false;
  const long long items =
      static_cast<long long>((s.sq + kBQ - 1) / kBQ) * b * s.h;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = flash_f32::Smem<D>::bytes;
  if (int e = set_smem(flash_fwd_f32_kernel<D>, bytes, &configured))
    return e;
  flash_fwd_f32_kernel<D><<<static_cast<int>(items), flash_f32::kThreads,
                            bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s, b);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, const Dims& s, int b, cudaStream_t stream) {
  static bool configured = false;
  const long long items =
      static_cast<long long>((s.sq + kTQ - 1) / kTQ) * b * s.h;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // with no keys no tile is copied, but a map needs a tensor: q's
  const bool keys = s.sk > 0;
  CUtensorMap qmap, kmap, vmap;
  if (int e = make_map(&qmap, q, b, s.sq, s.h, D)) return e;
  if (int e = make_map(&kmap, keys ? k : q, b, keys ? s.sk : s.sq,
                       keys ? s.hk : s.h, D))
    return e;
  if (int e = make_map(&vmap, keys ? v : q, b, keys ? s.sk : s.sq,
                       keys ? s.hk : s.h, D))
    return e;
  constexpr size_t bytes = FwdSmem<D>::bytes;
  if (int e = set_smem(flash_fwd_wgmma_kernel<D>, bytes, &configured))
    return e;
  flash_fwd_wgmma_kernel<D><<<static_cast<int>(items), kThreadsWG, bytes,
                              stream>>>(qmap, kmap, vmap,
                                        static_cast<bf16*>(out), lse, s, b);
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
  if (dtype == kBF16)
    return d == 64 ? launch_bf16<64>(q, k, v, out, l, s, b, st)
                   : launch_bf16<128>(q, k, v, out, l, s, b, st);
  if (dtype == kF32)
    return d == 64 ? launch_f32<64>(q, k, v, out, l, s, b, st)
                   : launch_f32<128>(q, k, v, out, l, s, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
