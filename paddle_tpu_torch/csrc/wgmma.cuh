// Hopper's warpgroup matrix multiply (`wgmma`) for the port's kernels:
// bf16 (or fp16) operands, f32 accumulators, shared-memory tiles without
// swizzle or with the 128-byte swizzle.
//
// Tile layout ("blocked"): a tile of R rows and C bf16 columns is stored
// as 8 x 8 core matrices (8 rows of 16 bytes, 128 contiguous bytes); the
// C / 8 core matrices of one 8-row group lie side by side, and the groups
// follow one another (16 * C bytes apart). One tile serves both operand
// orientations of wgmma, only its descriptor changes:
// - K-major (the tile's columns are the reduction axis K): LBO, the
//   stride between core matrices along K, is 128 bytes; SBO, along M or
//   N, is 16 * C; the next 16 columns of K start 256 bytes further;
// - MN-major (the tile's rows are K, its columns M or N; the `trans`
//   flag of the instruction): LBO, along K, is 16 * C; SBO, along M or
//   N, is 128; the next 16 rows of K start 32 * C bytes further.
// (The card tests hold every product built on these to its plain
// version.)
//
// Accumulators follow mma.sync's m16n8 layout per warp: the warp w of the
// warpgroup owns rows 16 w + g and 16 w + g + 8 (g = lane / 4), and
// d[4 n + e] is column 8 n + 2 (lane % 4) + (e & 1) of row e / 2. An A
// operand from registers takes mma.sync's m16n8k16 A fragment, so an
// accumulator re-packs into the next product's A (flash_mma.cuh pack_a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace ptt {
namespace wg {

// Byte offset of 16-byte chunk c8 of row r in a blocked tile of C
// columns.
template <int C>
__host__ __device__ constexpr int chunk_offset(int r, int c8) {
  return ((r >> 3) * (C / 8) + c8) * 128 + (r & 7) * 16;
}

// A shared-memory matrix descriptor (no swizzle) at shared address
// `addr` with the leading (K) and stride (M / N) byte offsets.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int lbo, int sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// The same with the 128-byte swizzle (tiles of 64-column boxes whose
// 8-row groups are 1024-byte atoms, 1024-byte aligned): K-major, SBO is
// the 1024-byte group stride and the next 16 columns start 32 bytes
// further; MN-major, LBO is the box stride along M / N and SBO 1024.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, int lbo,
                                               int sbo) {
  return desc(addr, lbo, sbo) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to accumulator registers across
// a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register A fragments: called before `fence` on every
// register a product reads, it keeps their definitions ahead of the
// fence (a definition the compiler sinks past it makes ptxas insert a
// fence of its own and serialize the kernel's wgmma).
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (m64 x nN, f32) = A B + (scale_d ? d : 0) over one k16 step. `ss`: A
// and B from shared memory (TA, TB: the MN-major flags); `rs`: A from
// registers (the m16n8k16 A fragment of the warp's 16 rows). The operand
// type T is bf16 or fp16 (`__half`): one instruction each, the same shapes
// and descriptors, TY its PTX name.
template <typename T>
constexpr bool kIsF16 = false;
template <>
constexpr bool kIsF16<__half> = true;

#define PTT_WG_D16                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define PTT_WG_D32                                                          \
  PTT_WG_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31])
#define PTT_WG_D64                                                          \
  PTT_WG_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),           \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PTT_WG_R16                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define PTT_WG_R32                                                          \
  PTT_WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, "                  \
             "%24, %25, %26, %27, %28, %29, %30, %31"
#define PTT_WG_R64                                                          \
  PTT_WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, "                  \
             "%40, %41, %42, %43, %44, %45, %46, %47, "                     \
             "%48, %49, %50, %51, %52, %53, %54, %55, "                     \
             "%56, %57, %58, %59, %60, %61, %62, %63"

#define PTT_WG_SS(N, TY, REGS, DOUT, A, P, T1, T2)                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY  \
               " {" REGS "}, %" A ", p, 1, 1, %" T1 ", %" T2 ";\n}\n"     \
               : DOUT                                                       \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))
#define PTT_WG_RS(N, TY, REGS, DOUT, A, P, T1)                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY  \
               " {" REGS "}, " A ", p, 1, 1, %" T1 ";\n}\n"               \
               : DOUT                                                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),       \
                 "r"(scale_d), "n"(TB))

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void ss_n32(float* d, uint64_t da, uint64_t db,
                                       int scale_d) {
  if constexpr (kIsF16<T>)
    PTT_WG_SS("32", "f16", PTT_WG_R16, PTT_WG_D16, "16, %17", "18", "19",
              "20");
  else
    PTT_WG_SS("32", "bf16", PTT_WG_R16, PTT_WG_D16, "16, %17", "18", "19",
              "20");
}

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void ss_n64(float* d, uint64_t da, uint64_t db,
                                       int scale_d) {
  if constexpr (kIsF16<T>)
    PTT_WG_SS("64", "f16", PTT_WG_R32, PTT_WG_D32, "32, %33", "34", "35",
              "36");
  else
    PTT_WG_SS("64", "bf16", PTT_WG_R32, PTT_WG_D32, "32, %33", "34", "35",
              "36");
}

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void ss_n128(float* d, uint64_t da, uint64_t db,
                                        int scale_d) {
  if constexpr (kIsF16<T>)
    PTT_WG_SS("128", "f16", PTT_WG_R64, PTT_WG_D64, "64, %65", "66", "67",
              "68");
  else
    PTT_WG_SS("128", "bf16", PTT_WG_R64, PTT_WG_D64, "64, %65", "66", "67",
              "68");
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void rs_n64(float* d, const uint32_t* a,
                                       uint64_t db, int scale_d) {
  if constexpr (kIsF16<T>)
    PTT_WG_RS("64", "f16", PTT_WG_R32, PTT_WG_D32, "{%32, %33, %34, %35}, %36",
              "37", "38");
  else
    PTT_WG_RS("64", "bf16", PTT_WG_R32, PTT_WG_D32,
              "{%32, %33, %34, %35}, %36", "37", "38");
}

template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void rs_n128(float* d, const uint32_t* a,
                                        uint64_t db, int scale_d) {
  if constexpr (kIsF16<T>)
    PTT_WG_RS("128", "f16", PTT_WG_R64, PTT_WG_D64,
              "{%64, %65, %66, %67}, %68", "69", "70");
  else
    PTT_WG_RS("128", "bf16", PTT_WG_R64, PTT_WG_D64,
              "{%64, %65, %66, %67}, %68", "69", "70");
}

#undef PTT_WG_SS
#undef PTT_WG_RS
#undef PTT_WG_R64
#undef PTT_WG_R32
#undef PTT_WG_R16
#undef PTT_WG_D64
#undef PTT_WG_D32
#undef PTT_WG_D16

template <int N, int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                   int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "ss: n32, n64 or n128");
  if constexpr (N == 32)
    ss_n32<TA, TB, T>(d, da, db, scale_d);
  else if constexpr (N == 64)
    ss_n64<TA, TB, T>(d, da, db, scale_d);
  else
    ss_n128<TA, TB, T>(d, da, db, scale_d);
}

template <int N, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db,
                                   int scale_d) {
  static_assert(N == 64 || N == 128, "rs: n64 or n128");
  if constexpr (N == 64)
    rs_n64<TB, T>(d, a, db, scale_d);
  else
    rs_n128<TB, T>(d, a, db, scale_d);
}

}  // namespace wg
}  // namespace ptt
