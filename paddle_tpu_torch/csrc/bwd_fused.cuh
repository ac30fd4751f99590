// Pieces shared by the two fused bf16 attention backward kernels, dense K7
// (flash_attention_bwd.cu) and varlen K8 (varlen_flash_attention_bwd.cu):
// the K / V staging into blocked wgmma tiles and the deterministic
// reduction of dq across CTAs. Each kernel chooses its own CTA shape.
//
// dq reduction: each CTA adds the dq partial of each (head, query tile) it
// walks into an f32 workspace tile (64 rows, padded by 4 so the fragment
// stores of the staging hit distinct banks) through a counter per tile.
// The partial is staged in shared memory and sent as one bulk copy (the
// first contributor) or one bulk reduce-add (`cp.reduce.async.bulk`, the
// others), each in its turn: a contributor waits until the counter shows
// its predecessor's add (no free atomics, so the sum's order is fixed and
// calls are bit-equal). The last contributor reads the workspace, adds its
// partial in registers and writes dq in bf16. A CTA releases a tile's
// counter once its bulk op has completed, in its next step after its first
// products (or at its end), and never while it waits itself.
#pragma once

#include "common.cuh"
#include "flash_mma.cuh"

namespace ptt {
namespace bwd {

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Spin until the counter at p reaches `want` (one thread). A wait that
// outlasts any schedule (about 2^26 polls, seconds) traps, so a broken
// order fails the launch instead of hanging the card.
__device__ __forceinline__ void wait_counter(const int* p, int want) {
  for (int n = 0; ld_acquire(p) < want; ++n) {
    if (n == (1 << 26)) __trap();
    __nanosleep(32);
  }
}

// Shared -> global bulk copy, and bulk reduce-add of f32 (each element
// of the destination += the source's), tracked by the bulk async-group.
__device__ __forceinline__ void bulk_store(void* g, const void* s,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          g),
      "r"(smem_u32(s)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_reduce_add(float* g, const float* s,
                                                unsigned bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(g),
      "r"(smem_u32(s)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The bulk ops of this thread are complete: their writes are performed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order this thread's shared writes before a later bulk op reads them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Order global accesses of the generic and the async proxy.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Thread 0: once the bulk op of the tile whose counter is `*pending` has
// completed, release the tile to its next contributor (the staging is
// then free again).
__device__ __forceinline__ void release_dq(int* sync, int* pending,
                                           int pending_val) {
  if (threadIdx.x != 0 || !*pending) return;
  bulk_wait();
  fence_async_global();
  st_release(sync + *pending, pending_val);
  *pending = 0;
}

// The dq side of one step: this CTA's add of its partial into the
// workspace tile of counter sync[cidx], tile cidx - 1 of `ws`. The thread
// holds partial rows mq + g and mq + g + 8, columns nc + 8 nd + 2 tig and
// one more (nd < NC / 8); each warpgroup holds NC of the D columns.
// `first` stores into the workspace, any other contributor waits until
// the counter reaches `want` and bulk-adds; the counter then reads
// `done`. The `last` contributor instead adds the workspace (unless it is
// also the first) to its partial in registers and writes dq in bf16: the
// tile's row r is row row0 + r of dq (rows of h heads of width D), `rows`
// of them real. Thread 0 keeps the counter of an add in flight in
// *pending (released by release_dq).
template <int D, int NC = D / 2>
__device__ __forceinline__ void add_dq(float (*dqa)[4], bool first,
                                       bool last, int* sync, int cidx,
                                       int want, int done, float* ws,
                                       __nv_bfloat16* dq, size_t row0,
                                       int h, int head, int rows, int mq,
                                       int nc, float* stg, int* pending,
                                       int* pending_val) {
  constexpr int LDW = D + 4;
  constexpr int kNtQ = NC / 8;
  constexpr unsigned kStageBytes = sizeof(float) * flash::kBQ * LDW;
  const int g = (threadIdx.x & 31) >> 2;
  const int tig = threadIdx.x & 3;
  float* wt = ws + static_cast<size_t>(cidx - 1) * (flash::kBQ * LDW);
  if (last) {
    if (!first) {
      // the earlier contributors' sum, then dq = sum + this partial
      if (threadIdx.x == 0) wait_counter(sync + cidx, want);
      __syncthreads();
#pragma unroll
      for (int nd = 0; nd < kNtQ; ++nd)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 w = __ldcg(reinterpret_cast<const float2*>(
              wt + (mq + g + half * 8) * LDW + nc + nd * 8 + tig * 2));
          dqa[nd][2 * half] = w.x + dqa[nd][2 * half];
          dqa[nd][2 * half + 1] = w.y + dqa[nd][2 * half + 1];
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mq + g + half * 8;
      if (r >= rows) continue;
      __nv_bfloat16* o = dq + ((row0 + r) * h + head) * D + nc + tig * 2;
#pragma unroll
      for (int nd = 0; nd < kNtQ; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(o + nd * 8) =
            __floats2bfloat162_rn(dqa[nd][2 * half], dqa[nd][2 * half + 1]);
    }
    return;
  }
#pragma unroll
  for (int nd = 0; nd < kNtQ; ++nd)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(stg + (mq + g + half * 8) * LDW + nc +
                                 nd * 8 + tig * 2) =
          make_float2(dqa[nd][2 * half], dqa[nd][2 * half + 1]);
  fence_async_shared();
  if (threadIdx.x == 0 && !first) wait_counter(sync + cidx, want);
  __syncthreads();  // the staging is complete; it is our turn
  if (threadIdx.x == 0) {
    fence_async_global();
    if (first)
      bulk_store(wt, stg, kStageBytes);
    else
      bulk_reduce_add(wt, stg, kStageBytes);
    bulk_commit();
    *pending = cidx;
    *pending_val = done;
  }
}

// ROWS rows of a head of width D into a blocked tile (wgmma.cuh) by all
// THREADS threads of the CTA (consecutive threads fill consecutive 16-byte
// chunks); rows at or past `limit` are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_blocked(__nv_bfloat16* dst,
                                                  const __nv_bfloat16* src,
                                                  size_t stride, int row0,
                                                  int limit) {
  constexpr int kChunks = D / 8;
  char* base = reinterpret_cast<char*>(dst);
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / (8 * kChunks) * 8 + (idx & 7);
    const int c8 = (idx >> 3) % kChunks;
    const bool ok = row0 + r < limit;
    flash::cp_async16(
        base + idx * 16,
        ok ? src + static_cast<size_t>(row0 + r) * stride + c8 * 8 : src, ok);
  }
}

}  // namespace bwd
}  // namespace ptt
