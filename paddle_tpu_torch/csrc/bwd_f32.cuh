// The f32 tile math shared by the two fused f32 attention backward kernels,
// dense (flash_attention_bwd.cu) and varlen (varlen_flash_attention_bwd.cu):
// the products of one step of a key tile's walk on the tensor cores as
// 3xTF32, and the ordered add of the dq partial. Each kernel keeps its own
// walk, its live-pair test and its dq order.
//
// 3xTF32: TF32 keeps 10 of f32's 23 mantissa bits, too few for f32
// results alone. Each f32 operand x is split as it is loaded into registers,
// big = tf32(x) (as cvt.rna: round to nearest, ties away) and small = x -
// big (exact in f32; the tensor core reads its TF32 bits), and a product a b
// takes three TF32 products accumulated in f32, the small terms first:
// a_small b_big + a_big b_small + a_big b_big. The dropped a_small b_small
// and the rounding of the small parts leave about 2^-21 of each product,
// near f32's own rounding, at three times the TF32 work (495 TFLOP/s dense
// on the H100 against 67 TFLOP/s of f32 FMA).
//
// The instruction is mma.sync m16n8k8 (TF32), whose operands are registers
// loaded by address: `wgmma` in kind::tf32 takes shared-memory operands
// K-major only, so the products whose reduction runs along the query rows
// (dV, dK) or the keys (dQ) would need transposed copies of dO, Q and K,
// and its shared operands could not be split in registers.
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
// An accumulator feeds the next product's A without a shuffle by taking
// the reduction index in a permuted order within each 8-wide step: the
// A fragment's column tig is the accumulator's column 2 tig and column
// tig + 4 is 2 tig + 1; the B operand is loaded by address in the same
// order. dQ takes the same order over the keys.
#pragma once

#include "bwd_fused.cuh"
#include "common.cuh"
#include "flash_mma.cuh"

namespace ptt {
namespace bwd32 {

constexpr int kBQ = flash::kBQ;  // query rows per step
constexpr int kLDS = kBQ + 4;    // row stride of dS^T (floats)

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

// tf32(x) as cvt.rna.tf32.f32 rounds it (to nearest, ties away from zero:
// half of the last kept bit added to the magnitude, the low 13 bits
// cleared), bit for bit for finite x, in two integer instructions, which
// issue faster than the conversion (scripts/torch_f32_bwd_variants.py:
// base against cvt_rna)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big = tf32(x); small = x - big, exact in f32, whose
// low 13 bits the tensor core drops (an mma reads the TF32 bits of each
// operand), which rounds it toward zero in place of a second rounding: the
// same accuracy at fewer instructions an element
// (scripts/torch_f32_bwd_variants.py: base against rna_small)
__device__ __forceinline__ void split(float x, uint32_t* big,
                                      uint32_t* small) {
  *big = to_tf32(x);
  *small = __float_as_uint(x - __uint_as_float(*big));
}

__device__ __forceinline__ void split4(const float* x, uint32_t* big,
                                       uint32_t* small) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], big + i, small + i);
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float* c, const uint32_t* ab,
                                     const uint32_t* as, float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, &bb0, &bs0);
  split(b1, &bb1, &bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// acc (the warp's 16 rows x 64 columns) = A B^T over D: A the warp's 16
// rows of a [..][LD] tile (K or V, from row r0), B the 64 rows of a
// [64][LD] tile (Q or dO). S^T and dP^T.
template <int D>
__device__ __forceinline__ void rows_by_rows(const float* a_tile, int r0,
                                             const float* b_tile,
                                             float (*acc)[4]) {
  constexpr int LD = Shape<D>::LD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // ldmatrix.x4: lanes 8 m .. 8 m + 7 give the rows of 8 x 4-float
  // matrix m; thread (g, tig) receives row g, float tig of each
  const float* ap =
      a_tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
  const float* bp =
      b_tile + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a[4], ab[4], as[4];
    flash::ldmatrix_x4(a, ap + kk * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ab + i, as + i);
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; nt += 2) {
      uint32_t b[4];
      flash::ldmatrix_x4(b, bp + nt * 8 * LD + kk * 8);
      mma3(acc[nt], ab, as, __uint_as_float(b[0]), __uint_as_float(b[1]));
      mma3(acc[nt + 1], ab, as, __uint_as_float(b[2]),
           __uint_as_float(b[3]));
    }
  }
}

// acc (the warp's 16 rows x D) += X B over the 64 query rows: X the warp's
// accumulator (P^T or dS^T: 16 keys x 64 queries), B a [64][LD] tile (dO or
// Q). dV and dK.
template <int D>
__device__ __forceinline__ void acc_by_rows(float (*x)[4],
                                            const float* b_tile,
                                            float (*acc)[4]) {
  constexpr int LD = Shape<D>::LD;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int kq = 0; kq < kBQ / 8; ++kq) {
    // A column tig is query 2 tig, column tig + 4 is query 2 tig + 1
    const float a[4] = {x[kq][0], x[kq][2], x[kq][1], x[kq][3]};
    uint32_t ab[4], as[4];
    split4(a, ab, as);
    const float* b0 = b_tile + (kq * 8 + 2 * tig) * LD + g;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      mma3(acc[nd], ab, as, b0[nd * 8], b0[LD + nd * 8]);
  }
}

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
