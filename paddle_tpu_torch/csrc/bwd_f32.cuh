// The f32 tile math shared by the two fused f32 attention backward kernels,
// dense (flash_attention_bwd.cu) and varlen (varlen_flash_attention_bwd.cu):
// the products of one step of a key tile's walk on the tensor cores as
// 3xTF32 (tf32x3.cuh, shared with the f32 forward), and the ordered add of
// the dq partial. Each kernel keeps its own walk, its live-pair test and
// its dq order.
//
// mma.sync m16n8k8 (TF32), not `wgmma`: `wgmma` in kind::tf32 takes
// shared-memory operands K-major only, so the products whose reduction
// runs along the query rows (dV, dK) or the keys (dQ) would need transposed
// copies of dO, Q and K, and its shared operands could not be split in
// registers.
//
// The CTA shape at head width D: BK keys (128 at D = 128, 64 at D = 64),
// each warp owning 16 of them (rows g and g + 8 of its m16 tiles, g = lane
// / 4, tig = lane % 4), over 64-row query tiles. f32 tiles in shared
// memory with rows padded by 4 floats (row stride = 4 mod 32 words), so
// the ldmatrix reads of K, V, Q, dO and the 4-byte fragment loads below
// hit distinct banks:
//   K, V  [BK][D + 4]   resident for the whole walk
//   Q     [64][D + 4]   one step's query rows
//   dO    [64][D + 4]   one step's upstream gradient, then dS^T [BK][68],
//                       then the dq partial's staging [64][D + 4]
// One step, per warp (P^T, dP^T, dS^T in accumulators, keys x queries):
//   S^T  = K Q^T     A = K  (ldmatrix), B = Q  (ldmatrix)
//   dV  += P^T dO    A = P^T (the accumulator itself), B = dO (by address)
//   dP^T = V dO^T    A = V  (ldmatrix), B = dO (ldmatrix)
//   dK  += dS^T Q    A = dS^T (the accumulator), B = Q (by address)
//   dQ   = dS K      A = dS^T (shared), B = K (by address); warp w takes
//                    query rows 16 (w % 4) .. and 64 columns from
//                    64 (w / 4)
// An accumulator feeds the next product's A in tf32x3.cuh's permuted
// order; dQ takes the same order over the keys.
#pragma once

#include "bwd_fused.cuh"
#include "common.cuh"
#include "flash_mma.cuh"
#include "tf32x3.cuh"

namespace ptt {
namespace bwd32 {

constexpr int kBQ = flash::kBQ;  // query rows per step
constexpr int kLDS = kBQ + 4;    // row stride of dS^T (floats)

using tf32x3::acc_by_rows;
using tf32x3::mma3;
using tf32x3::rows_by_rows;
using tf32x3::split4;

template <int D>
struct Shape {
  static constexpr int BK = D == 64 ? 64 : 128;  // keys per CTA
  static constexpr int kWarps = BK / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int LD = D + 4;  // row stride of K, V, Q, dO (floats)
  static constexpr int NC = D / (kWarps / 4);  // dq columns of a warp
  // shared memory in floats: K, V, Q, dO / dS^T, lse, delta
  static constexpr int k_off = 0;
  static constexpr int v_off = BK * LD;
  static constexpr int q_off = 2 * BK * LD;
  static constexpr int do_off = q_off + kBQ * LD;
  static constexpr int do_len = kBQ * LD > BK * kLDS ? kBQ * LD : BK * kLDS;
  static constexpr int lse_off = do_off + do_len;
  static constexpr int delta_off = lse_off + kBQ;
  static constexpr size_t bytes = sizeof(float) * (delta_off + kBQ);
  static_assert(NC == 64, "each warp adds 16 x 64 of dq");
  static_assert(LD % 32 == 4 && kLDS % 32 == 4, "padded rows");
};

// dq (the warp's 16 query rows from mq x 64 columns from nc) = dS K over
// the BK keys: dS^T a [BK][kLDS] tile, K a [BK][LD] tile.
template <int D>
__device__ __forceinline__ void dq_partial(const float* dst, const float* ks,
                                           int mq, int nc, float (*dqa)[4]) {
  constexpr int LD = Shape<D>::LD;
  constexpr int BK = Shape<D>::BK;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < BK / 8; ++kk) {
    // A column tig is key 2 tig, column tig + 4 is key 2 tig + 1
    const float* s0 = dst + (kk * 8 + 2 * tig) * kLDS + mq + g;
    const float a[4] = {s0[0], s0[8], s0[kLDS], s0[kLDS + 8]};
    uint32_t ab[4], as[4];
    split4(a, ab, as);
    const float* b0 = ks + (kk * 8 + 2 * tig) * LD + nc + g;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      mma3(dqa[nd], ab, as, b0[nd * 8], b0[LD + nd * 8]);
  }
}

// P^T (in sc) = exp(S^T scale - lse) where `live(c, half)` says query
// column c sees the thread's key row g (half 0) or g + 8 (half 1), else 0;
// dead pairs are taken to 0 by a select (a row with no live key has lse
// ~ -1e30, where exp overflows).
template <typename Live>
__device__ __forceinline__ void probs(float (*sc)[4], const float* ls,
                                      float scale, Live live) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = nt * 8 + tig * 2 + (e & 1);
      const float p = expf(sc[nt][e] * scale - ls[c]);
      sc[nt][e] = live(c, e >> 1) ? p : 0.f;
    }
}

// dS^T (in dp) = P^T (dP^T - delta) scale
__device__ __forceinline__ void dsoft(float (*dp)[4], float (*p)[4],
                                      const float* dls, float scale) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[nt][e] = p[nt][e] * (dp[nt][e] - dls[nt * 8 + tig * 2 + (e & 1)]) *
                  scale;
}

// The warp's dS^T rows (keys r0 + g, r0 + g + 8) into the [BK][kLDS] tile.
__device__ __forceinline__ void store_dst(float* dst, int r0,
                                          float (*ds)[4]) {
  const int lane = threadIdx.x & 31;
  float* row = dst + (r0 + (lane >> 2)) * kLDS + (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < kBQ / 8; ++nt) {
    *reinterpret_cast<float2*>(row + nt * 8) = make_float2(ds[nt][0],
                                                           ds[nt][1]);
    *reinterpret_cast<float2*>(row + 8 * kLDS + nt * 8) =
        make_float2(ds[nt][2], ds[nt][3]);
  }
}

// ROWS rows of width D (row i at src + (row0 + i) * stride) into a
// [ROWS][D + 4] tile by all THREADS threads, 16 bytes a copy; rows at or
// past `limit` are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              size_t stride, int row0,
                                              int limit) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 4;
    const bool ok = row0 + r < limit;
    flash::cp_async16(
        dst + r * (D + 4) + c,
        ok ? src + static_cast<size_t>(row0 + r) * stride + c : src, ok);
  }
}

// The warp's 16 x D accumulator rows (r0 + g, r0 + g + 8) in f32; `base`
// is row 0 of the output, rows `stride` apart, rows at or past `limit`
// not written.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* base, size_t stride,
                                               float (*acc)[4], int r0,
                                               int limit) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + (lane >> 2) + half * 8;
    if (r >= limit) continue;
    float* dst = base + static_cast<size_t>(r) * stride + (lane & 3) * 2;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(dst + nd * 8) =
          make_float2(acc[nd][2 * half], acc[nd][2 * half + 1]);
  }
}

// This CTA's add of its dq partial (rows mq + g, mq + g + 8, columns nc +
// 8 nd + 2 tig and the next, of a 64-row tile) into dq itself, f32, in the
// tile's fixed order, as bulk copies that run while the CTA goes on: the
// partial is staged in `stg` ([64][D + 4], rows padded as K's), then
// thread 0 waits until the tile's counter reaches `want` (unless
// `first`) and sends one bulk copy (`first`) or bulk reduce-add (f32, the
// others) per real row of the tile; dq's tile row r is at `tile` + r *
// stride, `rows` of them real. Called by every thread; thread 0 then
// owns the add until release_dq_f32.
template <int D>
__device__ __forceinline__ void add_dq_f32(float (*dqa)[4], bool first,
                                           const int* counter, int want,
                                           float* tile, size_t stride,
                                           int rows, int mq, int nc,
                                           float* stg) {
  constexpr int LD = D + 4;
  const int lane = threadIdx.x & 31;
  float* s0 = stg + (mq + (lane >> 2)) * LD + nc + (lane & 3) * 2;
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) {
    *reinterpret_cast<float2*>(s0 + nd * 8) =
        make_float2(dqa[nd][0], dqa[nd][1]);
    *reinterpret_cast<float2*>(s0 + 8 * LD + nd * 8) =
        make_float2(dqa[nd][2], dqa[nd][3]);
  }
  bwd::fence_async_shared();
  if (!first && threadIdx.x == 0) bwd::wait_counter(counter, want);
  __syncthreads();  // the staging is complete; it is our turn
  if (threadIdx.x == 0) {
    bwd::fence_async_global();
    const int n = rows < kBQ ? rows : kBQ;
    for (int r = 0; r < n; ++r) {
      float* g = tile + static_cast<size_t>(r) * stride;
      if (first)
        bwd::bulk_store(g, stg + r * LD, sizeof(float) * D);
      else
        bwd::bulk_reduce_add(g, stg + r * LD, sizeof(float) * D);
    }
    bwd::bulk_commit();
  }
}

// Thread 0: the last add's bulk ops have read their staging, which may be
// overwritten after the next barrier.
__device__ __forceinline__ void bulk_wait_read() {
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Thread 0: once the last add's bulk ops have completed, its tile's
// counter reads `done` (the next contributor's turn). A CTA releases in
// its next step after its first products (or at its end), never while it
// waits itself.
__device__ __forceinline__ void release_dq_f32(int** pending, int done) {
  if (threadIdx.x != 0 || *pending == nullptr) return;
  bwd::bulk_wait();
  bwd::fence_async_global();
  bwd::st_release(*pending, done);
  *pending = nullptr;
}

}  // namespace bwd32
}  // namespace ptt
