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
// Design: each CTA owns one 64-row query tile of one head. It finds its
// rows' segments by binary search in cu_seqlens_q, derives the contiguous
// key range those rows can see (segment bounds, the causal diagonal of its
// last row, the window edge of its first row) and walks only that range in
// 64-key tiles. The segment logic (live pairs, key ranges, tile tests, the
// tile order) lives in varlen_seg.cuh, shared with the backward kernels
// K8 (and K8a/K8b in f32); rows at or past cu_seqlens_q[-1] are padding,
// see nothing and write zeros. Online softmax statistics stay in f32.
// - bf16: FlashAttention-2 on the tensor cores, K4's pieces
//   (flash_mma.cuh): `mma.sync` m16n8k16, bf16 operands, f32 accumulation;
//   each of the 4 warps owns 16 query rows and keeps its Q fragments, the
//   16 x 64 scores and the 16 x D output accumulator in registers. The
//   score fragments are re-packed in place as the A operand of P.V (P
//   rounded to bf16, as the TPU kernel rounds P to v's dtype; the row sum
//   l uses the unrounded P); K's fragments come from ldmatrix, V's from
//   ldmatrix.trans; exp2 in one MUFU instruction (exp2_ftz) with scale *
//   log2(e) folded in. K and V tiles
//   stream through shared memory with cp.async in two stages. The test of
//   which key tile comes next runs ahead of its copy, so the next live tile
//   loads while this one computes and no byte of a dead tile is read: for a
//   query tile inside one segment (the common case) from positions alone,
//   else from the key indices written into a second pair of index arrays
//   (varlen_seg.cuh Walk, shared with K8). Tiles whose pairs are all
//   live skip the mask (kFull). The kernel is built for padded widths 64
//   and 128: a narrower head (any d % 16 == 0) is zero-filled to the
//   padded width in shared memory, so shared memory and registers follow
//   D (four CTAs per SM at 64, two at 128). A one-CTA order kernel
//   launched first from the same entry point ranks the query tiles by the
//   length of their key range, and the grid walks them heaviest first
//   (blockIdx.x = rank * H + head, the heads fastest). No atomics: every
//   output is written once, so two calls are bit-equal (recompute relies on
//   it).
// - f32: flash_f32.cuh's tile loop, shared with K4: both products on the
//   tensor cores as 3xTF32 (mma.sync m16n8k8, f32 results), the same walk
//   (Walk, kFull tiles unmasked), padded widths and heaviest-first order as
//   the bf16 path.
#include <climits>

#include "common.cuh"
#include "flash_f32.cuh"
#include "flash_mma.cuh"
#include "varlen_seg.cuh"

using namespace ptt;
using namespace ptt::varlen;

namespace {

namespace fl = ptt::flash;
using bf16 = __nv_bfloat16;
using fl::b_frags;
using fl::cp_async_commit;
using fl::cp_async_wait;
using fl::exp2_ftz;
using fl::kLog2e;
using fl::kThreadsTC;
using fl::lds32;
using fl::ldmatrix_x4_trans;
using fl::load_tile_cols;
using fl::mma_bf16;
using fl::pack_a;
using fl::set_smem;

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile
constexpr int kDMax = 128;
static_assert(kBQ == kBK && kBQ == flash_f32::kBQ && kBK == flash_f32::kBK &&
                  kBQ == kTile && kBQ == fl::kBQ && kBK == fl::kBK,
              "the bf16 and f32 paths and varlen_seg.cuh share the tiles");

// ------------------------------------------------------------------ bf16
// Shared memory: the Q tile, two stages of K and V tiles (rows padded to
// DP + 8 elements: 16-byte rows, no bank conflicts for ldmatrix), the
// query indices and two sets of key indices.
template <int DP>
constexpr size_t smem_bytes_tc() {
  return sizeof(bf16) * static_cast<size_t>(kBQ + 4 * kBK) * (DP + 8) +
         sizeof(int) * (2 * kBQ + 4 * kBK);
}

template <int DP>
__global__ void __launch_bounds__(kThreadsTC, DP == 64 ? 4 : 2)
    varlen_fwd_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const int* __restrict__ cu_q,
                           const int* __restrict__ cu_k,
                           const int* __restrict__ order,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           Seg s, int d) {
  constexpr int LD = DP + 8;
  constexpr int kSteps = DP / 16;
  constexpr int kNtS = kBK / 8;  // score n-tiles per warp
  constexpr int kNtO = DP / 8;   // output n-tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * LD;      // [2][kBK][LD]
  bf16* vs = ks + 2 * kBK * LD;  // [2][kBK][LD]
  int* qseg = reinterpret_cast<int*>(vs + 2 * kBK * LD);
  int* qrel = qseg + kBQ;
  int* kseg = qrel + kBQ;        // [2][kBK]
  int* krel = kseg + 2 * kBK;    // [2][kBK]
  __shared__ int krange[2];

  const int head = blockIdx.x % s.h;
  const int q0 = order[blockIdx.x / s.h] * kBQ;
  const int kvh = head / (s.h / s.hk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t q_stride = static_cast<size_t>(s.h) * d;
  const size_t kv_stride = static_cast<size_t>(s.hk) * d;
  const bf16* kb = k + static_cast<size_t>(kvh) * d;
  const bf16* vb = v + static_cast<size_t>(kvh) * d;

  query_rows(cu_q, cu_k, s.nseg, s.tq, q0, qseg, qrel);
  load_tile_cols<DP, LD>(qs, q + static_cast<size_t>(head) * d, q_stride, q0,
                         s.tq, d);
  __syncthreads();
  if (threadIdx.x == 0)
    key_range(cu_k, s.tq, s.tk, q0, qseg, qrel, s.causal, s.window, krange);
  __syncthreads();
  const int hi = krange[1];
  const Walk walk = key_walk(cu_k, qseg, qrel, hi, s.causal, s.window);
  // from the key tile at *kp on, the first live one: its state (kDead when
  // none is left); tiles tested by index write their key indices into set
  // `buf`
  auto next_tile = [&](int* kp, int buf) -> int {
    return next_key_tile(cu_k, s.nseg, walk, kp, hi, qseg, qrel,
                         kseg + buf * kBK, krel + buf * kBK);
  };
  int k0 = krange[0];
  int state = next_tile(&k0, 0);
  if (state != kDead) {
    load_tile_cols<DP, LD>(ks, kb, kv_stride, k0, hi, d);
    load_tile_cols<DP, LD>(vs, vb, kv_stride, k0, hi, d);
  }
  cp_async_commit();

  // the thread's rows r0, r0 + 8 of the tile: segment ids and relative
  // positions for the mask of partial tiles
  const int r0 = warp * 16 + g;
  const int rseg[2] = {qseg[r0], qseg[r0 + 8]};
  const int rrel[2] = {qrel[r0], qrel[r0 + 8]};
  float o[kNtO][4];
#pragma unroll
  for (int i = 0; i < kNtO; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of scaled scores
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  uint32_t qf[kSteps][4];
  const float scale_log2 = s.scale * kLog2e;
  bool first = true;
  int stage = 0;

  while (state != kDead) {
    // the next live tile: its index test runs while this tile's copy is in
    // flight, then its own copy goes out before this tile computes
    int nk0 = k0 + kBK;
    const int nstate = next_tile(&nk0, stage ^ 1);
    if (nstate != kDead) {
      load_tile_cols<DP, LD>(ks + (stage ^ 1) * kBK * LD, kb, kv_stride, nk0,
                             hi, d);
      load_tile_cols<DP, LD>(vs + (stage ^ 1) * kBK * LD, vb, kv_stride, nk0,
                             hi, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (first) {
      const bf16* qw = qs + r0 * LD + tig * 2;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        qf[kk][0] = lds32(qw + kk * 16);
        qf[kk][1] = lds32(qw + 8 * LD + kk * 16);
        qf[kk][2] = lds32(qw + kk * 16 + 8);
        qf[kk][3] = lds32(qw + 8 * LD + kk * 16 + 8);
      }
      first = false;
    }
    const bf16* kt = ks + stage * kBK * LD;
    const bf16* vt = vs + stage * kBK * LD;
    const int* ksg = kseg + stage * kBK;
    const int* krl = krel + stage * kBK;

    // S = Q K^T (raw dot products) for the warp's 16 rows x 64 keys
    float sc[kNtS][4];
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int nt = 0; nt < kNtS; nt += 2) {
        uint32_t bf[4];
        b_frags<LD>(bf, kt, nt, kk, lane);
        mma_bf16(sc[nt], qf[kk], bf[0], bf[1]);
        mma_bf16(sc[nt + 1], qf[kk], bf[2], bf[3]);
      }

    // mask (partial tiles only): dead pairs to -inf, which exp sends to 0
    if (state == kPartial) {
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + tig * 2 + (e & 1);
          if (!walk.live(rseg[e >> 1], rrel[e >> 1], ksg, krl, k0, c))
            sc[nt][e] = -INFINITY;
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
      const float alpha = exp2_ftz((m[half] - m_new) * kLog2e);
      const float ml = m_new * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNtS; ++nt) {
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e) {
          const float p = exp2_ftz(fmaf(sc[nt][e], scale_log2, -ml));
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
      pack_a(a, sc, kk);
      const bf16* vr = vt + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < kNtO; nd += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vr + nd * 8);
        mma_bf16(o[nd], a, bf[0], bf[1]);
        mma_bf16(o[nd + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iterations refill this stage's tiles and
                      // key indices
    k0 = nk0;
    state = nstate;
    stage ^= 1;
  }
  cp_async_wait<0>();  // the Q copy, when no tile was live

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int qi = q0 + r0 + half * 8;
    if (qi < s.tq) {
      const float lc = fmaxf(lt, 1e-30f);
      const float inv = 1.f / lc;
      bf16* dst = out + (static_cast<size_t>(qi) * s.h + head) * d + tig * 2;
#pragma unroll
      for (int nd = 0; nd < kNtO; ++nd)
        if (nd * 8 < d)
          *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8) =
              __floats2bfloat162_rn(o[nd][2 * half] * inv,
                                    o[nd][2 * half + 1] * inv);
      if (tig == 0)
        lse[static_cast<size_t>(head) * s.tq + qi] = m[half] + logf(lc);
    }
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, const int* cu_q,
                const int* cu_k, int* order, void* out, float* lse,
                const Seg& s, int d, cudaStream_t st) {
  const int ntiles = (s.tq + kBQ - 1) / kBQ;
  if (int e = launch_tile_order(cu_q, cu_k, s, 0, ntiles, order, st))
    return e;
  static bool configured = false;
  constexpr size_t bytes = smem_bytes_tc<DP>();
  if (int e = set_smem(varlen_fwd_bf16_kernel<DP>, bytes, &configured))
    return e;
  varlen_fwd_bf16_kernel<DP><<<ntiles * s.h, kThreadsTC, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), cu_q, cu_k, order,
      static_cast<bf16*>(out), lse, s, d);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- f32
// flash_f32.cuh's 3xTF32 tile loop, built for padded widths 64 and 128 as
// the bf16 path is; the policy below walks the segment-aware tiles as the
// bf16 path does (varlen_seg.cuh Walk: from positions alone inside one
// segment, else from two sets of key indices appended to flash_f32's
// shared memory), and the grid walks the query tiles in the order kernel's
// ranks, heaviest first.
template <int DP>
constexpr size_t smem_bytes_f32() {
  return flash_f32::Smem<DP>::bytes + sizeof(int) * (2 * kBQ + 4 * kBK);
}

struct SegmentTiles {
  const int* cu_k;
  int nseg, khi;
  Walk walk;
  const int *qseg, *qrel;
  int *kseg, *krel;  // [2][kBK]

  __device__ int tile(int k0, int set) {
    return key_tile_state(cu_k, nseg, walk, k0, khi, qseg, qrel,
                          kseg + set * kBK, krel + set * kBK);
  }
  __device__ bool live(int r, int k0, int c, int set) const {
    return walk.live(qseg[r], qrel[r], kseg + set * kBK, krel + set * kBK,
                     k0, c);
  }
};
static_assert(flash_f32::kDead == kDead && flash_f32::kPartial == kPartial &&
                  flash_f32::kFull == kFull,
              "flash_f32.cuh takes varlen_seg.cuh's tile states");

template <int DP>
__global__ void __launch_bounds__(flash_f32::kThreads, DP == 64 ? 3 : 2)
    varlen_fwd_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ cu_q,
                          const int* __restrict__ cu_k,
                          const int* __restrict__ order,
                          float* __restrict__ out, float* __restrict__ lse,
                          Seg s, int d) {
  const int head = blockIdx.x % s.h;
  const int q0 = order[blockIdx.x / s.h] * kBQ;
  const int kvh = head / (s.h / s.hk);

  extern __shared__ __align__(16) float smem[];
  int* qseg = reinterpret_cast<int*>(smem + flash_f32::Smem<DP>::floats);
  int* qrel = qseg + kBQ;
  int* kseg = qrel + kBQ;  // [2][kBK]
  int* krel = kseg + 2 * kBK;  // [2][kBK]
  __shared__ int krange[2];

  query_rows(cu_q, cu_k, s.nseg, s.tq, q0, qseg, qrel);
  __syncthreads();
  if (threadIdx.x == 0)
    key_range(cu_k, s.tq, s.tk, q0, qseg, qrel, s.causal, s.window, krange);
  __syncthreads();
  const int hi = krange[1];
  SegmentTiles tiles{cu_k, s.nseg, hi,
                     key_walk(cu_k, qseg, qrel, hi, s.causal, s.window),
                     qseg, qrel, kseg, krel};
  const size_t row = static_cast<size_t>(s.h) * d;
  flash_f32::attend<DP>(q + (static_cast<size_t>(q0) * s.h + head) * d, row,
                        min(kBQ, s.tq - q0), k + static_cast<size_t>(kvh) * d,
                        v + static_cast<size_t>(kvh) * d,
                        static_cast<size_t>(s.hk) * d, krange[0], hi, d,
                        s.scale, tiles,
                        out + (static_cast<size_t>(q0) * s.h + head) * d, row,
                        lse + static_cast<size_t>(head) * s.tq + q0, smem);
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, const int* cu_q,
               const int* cu_k, int* order, void* out, float* lse,
               const Seg& s, int d, cudaStream_t st) {
  const int ntiles = (s.tq + kBQ - 1) / kBQ;
  if (int e = launch_tile_order(cu_q, cu_k, s, 0, ntiles, order, st))
    return e;
  static bool configured = false;
  constexpr size_t bytes = smem_bytes_f32<DP>();
  if (int e = set_smem(varlen_fwd_f32_kernel<DP>, bytes, &configured))
    return e;
  varlen_fwd_f32_kernel<DP><<<ntiles * s.h, flash_f32::kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), cu_q, cu_k, order,
      static_cast<float*>(out), lse, s, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (Tq, H, D), k / v (Tk, HK, D), out like q, lse (H, Tq) f32, cu_q /
// cu_k (nseg + 1,) int32, order int32 scratch of ceil(Tq / 64) (the tile
// order); all contiguous. D is a multiple of 16 up to 128;
// window 0 means none.
extern "C" int ptt_varlen_flash_attention(
    const void* q, const void* k, const void* v, const void* cu_q,
    const void* cu_k, void* order, void* out, void* lse, int tq, int tk,
    int nseg, int h, int hk, int d, int causal, int window, float sm_scale,
    int dtype, void* stream) {
  if (tq <= 0) return 0;
  const int ntiles = (tq + kBQ - 1) / kBQ;
  if (nseg <= 0 || hk <= 0 || h % hk != 0 || d <= 0 || d > kDMax ||
      d % 16 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cq = static_cast<const int*>(cu_q);
  const int* ck = static_cast<const int*>(cu_k);
  float* l = static_cast<float*>(lse);
  const Seg s{tq, tk, nseg, h, hk, causal, window, sm_scale};
  if (static_cast<long long>(ntiles) * h > INT_MAX)  // the grid's x
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    return d <= 64 ? launch_bf16<64>(q, k, v, cq, ck, static_cast<int*>(order),
                                     out, l, s, d, st)
                   : launch_bf16<128>(q, k, v, cq, ck,
                                      static_cast<int*>(order), out, l, s, d,
                                      st);
  if (dtype == kF32)
    return d <= 64 ? launch_f32<64>(q, k, v, cq, ck, static_cast<int*>(order),
                                    out, l, s, d, st)
                   : launch_f32<128>(q, k, v, cq, ck,
                                     static_cast<int*>(order), out, l, s, d,
                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}
