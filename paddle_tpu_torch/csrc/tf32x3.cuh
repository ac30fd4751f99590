// The 3xTF32 products shared by the f32 attention kernels on the tensor
// cores: the fused f32 backwards (bwd_f32.cuh: dense K7 in
// flash_attention_bwd.cu, varlen K8 in varlen_flash_attention_bwd.cu) and
// the f32 forward tile loop (flash_f32.cuh: dense K4, varlen K3).
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
// loaded by address (thread (g = lane / 4, tig = lane % 4) holds rows g and
// g + 8 of an m16 tile). Tiles are f32 in shared memory with rows padded by
// 4 floats (row stride D + 4 = 4 mod 32 words), so the ldmatrix reads and
// the 4-byte fragment loads below hit distinct banks. The two products:
//   rows_by_rows  acc = A B^T over D: a warp's 16 rows of one tile against
//                 the 64 rows of another (S = Q K^T in the forward; S^T =
//                 K Q^T and dP^T = V dO^T in the backward)
//   acc_by_rows   acc += X B over 64 rows: X an accumulator of the first
//                 kind, B a tile by address (O += P V in the forward; dV +=
//                 P^T dO and dK += dS^T Q in the backward)
// An accumulator feeds the next product's A without a shuffle by taking
// the reduction index in a permuted order within each 8-wide step: the
// A fragment's column tig is the accumulator's column 2 tig and column
// tig + 4 is 2 tig + 1; the B operand is loaded by address in the same
// order.
#pragma once

#include "common.cuh"
#include "flash_mma.cuh"

namespace ptt {
namespace tf32x3 {

constexpr int kRows = 64;  // rows of a B tile: the columns of an accumulator

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
// rows of a [..][D + 4] tile (from row r0; Q in the forward, K or V in the
// backward), B the 64 rows of a [64][D + 4] tile (K; Q or dO). S, S^T and
// dP^T.
template <int D>
__device__ __forceinline__ void rows_by_rows(const float* a_tile, int r0,
                                             const float* b_tile,
                                             float (*acc)[4]) {
  constexpr int LD = D + 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < kRows / 8; ++nt)
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
    for (int nt = 0; nt < kRows / 8; nt += 2) {
      uint32_t b[4];
      flash::ldmatrix_x4(b, bp + nt * 8 * LD + kk * 8);
      mma3(acc[nt], ab, as, __uint_as_float(b[0]), __uint_as_float(b[1]));
      mma3(acc[nt + 1], ab, as, __uint_as_float(b[2]),
           __uint_as_float(b[3]));
    }
  }
}

// acc (the warp's 16 rows x D) += X B over 64 rows: X the warp's
// accumulator (P: 16 queries x 64 keys in the forward; P^T or dS^T: 16 keys
// x 64 queries in the backward), B a [64][D + 4] tile (V; dO or Q). O, dV
// and dK.
template <int D>
__device__ __forceinline__ void acc_by_rows(float (*x)[4],
                                            const float* b_tile,
                                            float (*acc)[4]) {
  constexpr int LD = D + 4;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int kq = 0; kq < kRows / 8; ++kq) {
    // A column tig is row 2 tig of B, column tig + 4 is row 2 tig + 1
    const float a[4] = {x[kq][0], x[kq][2], x[kq][1], x[kq][3]};
    uint32_t ab[4], as[4];
    split4(a, ab, as);
    const float* b0 = b_tile + (kq * 8 + 2 * tig) * LD + g;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      mma3(acc[nd], ab, as, b0[nd * 8], b0[LD + nd * 8]);
  }
}

}  // namespace tf32x3
}  // namespace ptt
