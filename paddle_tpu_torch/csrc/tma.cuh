// Hopper's Tensor Memory Accelerator (TMA) and shared-memory barriers
// (`mbarrier`) for the port's kernels: the dense flash-attention forward
// K4 (flash_attention.cu) and backward K7 (flash_attention_bwd.cu).
//
// A (B, S, H, D) bf16 tensor is described once on the host as a tensor
// map of 64-row x 64-column boxes of one head (`make_map`); one thread
// asks for a box (`tma_box`), which lands in shared memory in the 128-byte
// swizzle that wgmma.cuh's `desc_sw128` reads, and completes on an
// mbarrier that the waiting threads armed with the bytes to expect
// (`mbar_expect_tx`). A box's shared destination is 1024-byte aligned.
// Rows past S read as zeros.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace ptt {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA)
// before any copy completes on them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` of the barrier to complete; a
// wait that outlasts any schedule traps, so a broken pipeline fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1 << 22)) __trap();
  }
}

// One 64-row x 64-column box of a (B, S, H, D) bf16 tensor into shared
// memory (128-byte swizzle), completing on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int d0, int h, int s0, int b,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(s0), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A (B, S, H, D) bf16 tensor as TMA boxes of 64 rows x 64 columns of one
// head, 128-byte swizzle; rows past S read as zeros. The encoder comes
// from the driver through the runtime, so the library links no -lcuda.
inline int make_map(CUtensorMap* m, const void* base, int b, int s, int h,
                    int d) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(h) * d * 2,
      static_cast<cuuint64_t>(s) * h * d * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ptt
