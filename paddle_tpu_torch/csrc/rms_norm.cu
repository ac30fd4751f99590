// RMSNorm forward (K1) and backward (K6) for Hopper.
//
// K1 replaces: paddle_tpu/ops/pallas/rms_norm.py, `_rms_fwd` -> `_fwd_kernel`
// (row-blocked Pallas kernel: r = rsqrt(mean(x^2) + eps), y = x * r * w in
// f32, r saved per row for the backward). K6 (below) replaces `_rms_bwd`
// -> `_bwd_kernel`.
//
// Bound on the H100: bytes. Each element is read once and written once and
// costs a handful of flops, far below the ~295 flop/byte ridge, so the time
// floor is (2 * rows * N * elem + N * elem) / 3.35 TB/s.
//
// Design: one CTA per row. Threads read the row with 16-byte vector loads
// (neighbouring threads on neighbouring addresses), square-sum in f32,
// reduce with warp shuffles and one shared-memory step, then make a second
// pass over the row (now in L1/L2) to write y = x * r * w. Math is f32 for
// bf16 and f32 inputs alike, as in the TPU kernel.
#include "common.cuh"

using namespace ptt;

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ rstd, int n,
                    float eps, bool vec) {
  constexpr int V = Vec<T>::N;
  const size_t row = blockIdx.x;
  const T* xr = x + row * n;
  T* yr = y + row * n;

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * V; i < n; i += THREADS * V) {
      float v[V];
      load_vec(xr + i, v);
#pragma unroll
      for (int k = 0; k < V; ++k) ss = fmaf(v[k], v[k], ss);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }

  __shared__ float red[THREADS / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < THREADS / 32 ? red[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / static_cast<float>(n) + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[row] = r;

  if (vec) {
    for (int i = threadIdx.x * V; i < n; i += THREADS * V) {
      float v[V], g[V];
      load_vec(xr + i, v);
      load_vec(w + i, g);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = v[k] * r * g[k];
      store_vec(yr + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
    }
  }
}

template <typename T>
static void launch(const void* x, const void* w, void* y, float* rstd,
                   int rows, int n, float eps, cudaStream_t stream) {
  const bool vec = (n % Vec<T>::N == 0) && aligned16(x) && aligned16(w) &&
                   aligned16(y);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (n >= 256 * Vec<T>::N) {
    rms_norm_kernel<T, 256><<<rows, 256, 0, stream>>>(xp, wp, yp, rstd, n,
                                                       eps, vec);
  } else {
    rms_norm_kernel<T, 128><<<rows, 128, 0, stream>>>(xp, wp, yp, rstd, n,
                                                       eps, vec);
  }
}

extern "C" int ptt_rms_norm(const void* x, const void* w, void* y,
                            void* rstd, int rows, int n, float eps,
                            int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  if (dtype == kF32) {
    launch<float>(x, w, y, r, rows, n, eps, s);
  } else if (dtype == kBF16) {
    launch<__nv_bfloat16>(x, w, y, r, rows, n, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- K6
// RMSNorm backward. Replaces: paddle_tpu/ops/pallas/rms_norm.py, `_rms_bwd`
// -> `_bwd_kernel`: g = dy * w, dx = g * r - x * r^3 * mean(g * x) per row,
// dw = sum over rows of dy * x * r, all in f32.
//
// Bound on the H100: bytes. x and dy are read and dx written once (plus w,
// r and dw), a few flops per element: (3 * rows * N * elem) / 3.35 TB/s.
//
// Design: the TPU kernel carries dw in scratch across its sequential grid;
// here CTAs run in parallel, so each sums its own rows and a second launch
// adds the sums. The host plan (ops/rms_norm.py `BwdPlan`) fixes both.
// 1. The row pass: about two persistent CTAs an SM, each walking a
//    contiguous range of rows. Each thread owns a fixed set of 16-byte
//    column vectors (strided by the CTA's width, so a warp's accesses
//    coalesce) and keeps its slice of w and its dw sums in registers for
//    the whole CTA: no shared read-modify-write, no bank conflict. Every
//    row is read once: a thread copies its own vectors of x and dy into a
//    two-row ring in shared memory (cp.async), one row ahead of the row it
//    works on, and reads back only what it copied, so
//    `cp.async.wait_group` alone orders the ring (a deeper ring measured
//    no faster: scripts/torch_rms_norm_variants.py). g·x is summed per
//    thread, across a warp by butterfly and across warps through two
//    slots of warp sums used in turns: one barrier a row, with the next
//    row's loads in flight across it. dx is written from the registers
//    that hold x and g, and each CTA ends by writing one f32 row of dw
//    partials. Widths that do not split into 16-byte vectors take a
//    general kernel of the same plan that keeps its dw sums in its
//    partial row.
// 2. The reduction: one CTA per 32 columns; warp k sums the partial rows
//    k, k + 16, ... in order, and the 16 warp sums meet in a fixed
//    pairwise tree. No atomics: dw is bit-equal across calls.

constexpr int kBwdMaxThreads = 256;  // ops/rms_norm.py BWD_MAX_THREADS
constexpr int kBwdMaxElems = 32;     // BWD_MAX_ELEMS
constexpr int kStages = 2;           // BWD_STAGES
constexpr int kRedWarps = 16;        // RED_WARPS
constexpr int kRedCols = 32;         // RED_COLS

// Rows [lo, hi) of this CTA: the plan's balanced split (`row_range`).
__device__ __forceinline__ void row_range(int rows, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(blockIdx.x) * rows /
                        gridDim.x);
  hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * rows /
                        gridDim.x);
}

// The CTA's sum of one value per thread: a warp butterfly, then the warp
// sums in warp order from `slot`. Rows use two slots in turns: a slot is
// rewritten two rows later, behind the next row's barrier, which every
// thread passes only after reading it here.
__device__ __forceinline__ float row_sum(float v, float* slot, int nwarps) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int k = 0; k < nwarps; ++k) t += slot[k];
  return t;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f32(e[i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kBwdMaxThreads)
    rms_norm_bwd_rows_kernel(const T* __restrict__ x,
                             const T* __restrict__ w,
                             const float* __restrict__ rstd,
                             const T* __restrict__ dy, T* __restrict__ dx,
                             float* __restrict__ part, int rows, int n) {
  constexpr int V = Vec<T>::N;
  extern __shared__ uint4 ring[];  // [kStages][2][nvec]: a row's x, dy
  __shared__ float red[2][kBwdMaxThreads / 32];
  const int nvec = n / V, tid = threadIdx.x, nthr = blockDim.x;
  int lo, hi;
  row_range(rows, lo, hi);
  const int cnt = hi - lo;

  float wv[VPT][V], acc[VPT][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = j * nthr + tid;
    if (c < nvec) {
      load_vec(w + static_cast<size_t>(c) * V, wv[j]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) wv[j][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[j][k] = 0.f;
  }

  // Copies this thread's vectors of the CTA's row `i` into ring stage
  // `slot` and returns its r; one commit group per row, empty past the
  // last row, so wait_group<kStages - 1> means "row i has landed".
  auto stage = [&](int i, int slot) -> float {
    float r = 0.f;
    if (i < cnt) {
      const int row = lo + i;
      uint4* s = ring + static_cast<size_t>(slot) * 2 * nvec;
      const T* xr = x + static_cast<size_t>(row) * n;
      const T* dr = dy + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = j * nthr + tid;
        if (c < nvec) {
          cp_async16(s + c, xr + static_cast<size_t>(c) * V);
          cp_async16(s + nvec + c, dr + static_cast<size_t>(c) * V);
        }
      }
      r = __ldg(rstd + row);
    }
    cp_async_commit();
    return r;
  };

  // r of the rows in the ring, by stage. The row loop is unrolled by
  // kStages, so row i sits in stage i % kStages and every index below is
  // a constant: r stays in registers, its load in flight as long as the
  // row's copies.
  float rq[kStages];
#pragma unroll
  for (int k = 0; k + 1 < kStages; ++k) rq[k] = stage(k, k);

  const float inv_n = 1.f / static_cast<float>(n);
  for (int base = 0; base < cnt; base += kStages) {
#pragma unroll
    for (int u = 0; u < kStages; ++u) {
      const int i = base + u;
      if (i >= cnt) break;
      constexpr int kAhead = kStages - 1;
      rq[(u + kAhead) % kStages] = stage(i + kAhead, (u + kAhead) % kStages);
      cp_async_wait<kAhead>();
      const uint4* s = ring + static_cast<size_t>(u) * 2 * nvec;
      const float r = rq[u];
      // x and g = dy w stay in registers across the row's barrier; the dw
      // sums take dy x r before it
      float xv[VPT][V], g[VPT][V];
      float gx = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = j * nthr + tid;
        if (c < nvec) {
          float dv[V];
          unpack<T>(s[c], xv[j]);
          unpack<T>(s[nvec + c], dv);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            g[j][k] = dv[k] * wv[j][k];
            gx = fmaf(g[j][k], xv[j][k], gx);
            acc[j][k] = fmaf(dv[k] * xv[j][k], r, acc[j][k]);
          }
        }
      }
      const float cf = r * r * r * row_sum(gx, red[i & 1], nthr >> 5) * inv_n;
      T* dxr = dx + static_cast<size_t>(lo + i) * n;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = j * nthr + tid;
        if (c < nvec) {
          float o[V];
#pragma unroll
          for (int k = 0; k < V; ++k)
            o[k] = fmaf(g[j][k], r, -(xv[j][k] * cf));
          store_vec(dxr + static_cast<size_t>(c) * V, o);
        }
      }
    }
  }

  float* pr = part + static_cast<size_t>(blockIdx.x) * n;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = j * nthr + tid;
    if (c < nvec) {
#pragma unroll
      for (int k = 0; k < V; k += 4)
        *reinterpret_cast<float4*>(pr + static_cast<size_t>(c) * V + k) =
            make_float4(acc[j][k], acc[j][k + 1], acc[j][k + 2],
                        acc[j][k + 3]);
    }
  }
}

// The general path: any width and alignment. Thread t owns the columns
// t, t + blockDim.x, ... and adds its dw sums straight into its partial row.
template <typename T>
__global__ void __launch_bounds__(kBwdMaxThreads)
    rms_norm_bwd_any_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ rstd,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ part, int rows, int n) {
  __shared__ float red[2][kBwdMaxThreads / 32];
  const int tid = threadIdx.x, nthr = blockDim.x;
  int lo, hi;
  row_range(rows, lo, hi);
  float* pr = part + static_cast<size_t>(blockIdx.x) * n;
  for (int i = tid; i < n; i += nthr) pr[i] = 0.f;
  const float inv_n = 1.f / static_cast<float>(n);
  for (int row = lo; row < hi; ++row) {
    const T* xr = x + static_cast<size_t>(row) * n;
    const T* dr = dy + static_cast<size_t>(row) * n;
    const float r = rstd[row];
    float gx = 0.f;
    for (int i = tid; i < n; i += nthr) {
      const float xv = to_f32(xr[i]), dv = to_f32(dr[i]);
      gx = fmaf(dv * to_f32(w[i]), xv, gx);
      pr[i] = fmaf(dv * xv, r, pr[i]);
    }
    const float cf = r * r * r * row_sum(gx, red[(row - lo) & 1], nthr >> 5)
                     * inv_n;
    T* dxr = dx + static_cast<size_t>(row) * n;
    for (int i = tid; i < n; i += nthr) {
      const float xv = to_f32(xr[i]), dv = to_f32(dr[i]);
      dxr[i] = from_f32<T>(fmaf(dv * to_f32(w[i]), r, -(xv * cf)));
    }
  }
}

// dw[c] = the sum of part[p][c] over p: warp k sums p = k, k + kRedWarps,
// ... in order, then the warp sums meet in a pairwise tree (`red_tree`).
template <typename T>
__global__ void __launch_bounds__(kRedWarps * 32)
    rms_norm_dw_kernel(const float* __restrict__ part, T* __restrict__ dw,
                       int nparts, int n) {
  __shared__ float sums[kRedWarps][kRedCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kRedCols + lane;
  float v = 0.f;
  if (c < n) {
    // the loads do not wait on the sum: sixteen in flight a thread
#pragma unroll 16
    for (int p = warp; p < nparts; p += kRedWarps)
      v += part[static_cast<size_t>(p) * n + c];
  }
  sums[warp][lane] = v;
#pragma unroll
  for (int h = kRedWarps / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (warp < h) sums[warp][lane] += sums[warp + h][lane];
  }
  if (warp == 0 && c < n) dw[c] = from_f32<T>(sums[0][lane]);
}

// The largest ring of the vector path: two rows of 256 threads x 32 f32.
constexpr int kMaxRing = kStages * 2 * kBwdMaxThreads * kBwdMaxElems * 4;

// Once per instance and device (the host cost stays off every launch):
// the ring may take up to kMaxRing of dynamic shared memory, and the SM's
// unified L1 / shared memory split leans to shared memory (the ring's
// copies bypass L1), so that the plan's CTAs an SM fit.
template <typename T, int VPT>
static cudaError_t prepare_ring() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ready[dev])) return e;
  auto kernel = rms_norm_bwd_rows_kernel<T, VPT>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxRing);
  if (e == cudaSuccess && dev < 64) ready[dev] = true;
  return e;
}

// The row pass on the vector path, the plan's instance. With `fit`, it
// launches nothing and stores the CTAs an SM holds in *fit.
template <typename T, int VPT>
static cudaError_t rows_pass(const void* x, const void* w, const float* rstd,
                             const void* dy, void* dx, float* part, int rows,
                             int n, int ctas, int threads, cudaStream_t s,
                             int* fit) {
  const size_t smem = static_cast<size_t>(kStages) * 2 * (n / Vec<T>::N) *
                      sizeof(uint4);
  auto kernel = rms_norm_bwd_rows_kernel<T, VPT>;
  cudaError_t e = prepare_ring<T, VPT>();
  if (e != cudaSuccess) return e;
  if (fit != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(fit, kernel, threads,
                                                         smem);
  kernel<<<ctas, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, n);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t rows_pass_any(int vpt, const void* x, const void* w,
                                 const float* rstd, const void* dy, void* dx,
                                 float* part, int rows, int n, int ctas,
                                 int threads, cudaStream_t s, int* fit) {
  switch (vpt) {
    case 1: return rows_pass<T, 1>(x, w, rstd, dy, dx, part, rows, n, ctas,
                                   threads, s, fit);
    case 2: return rows_pass<T, 2>(x, w, rstd, dy, dx, part, rows, n, ctas,
                                   threads, s, fit);
    case 4: return rows_pass<T, 4>(x, w, rstd, dy, dx, part, rows, n, ctas,
                                   threads, s, fit);
    case 8:
      // a thread holds at most kBwdMaxElems elements of a row
      if constexpr (8 * Vec<T>::N <= kBwdMaxElems)
        return rows_pass<T, 8>(x, w, rstd, dy, dx, part, rows, n, ctas,
                               threads, s, fit);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_bwd(const void* x, const void* w, const float* rstd,
                      const void* dy, void* dx, float* part, void* dw,
                      int rows, int n, int ctas, int threads, int vpt,
                      cudaStream_t s) {
  cudaError_t e;
  if (vpt > 0) {
    const int nvec = n / Vec<T>::N;
    if (n % Vec<T>::N != 0 || !aligned16(x) || !aligned16(w) ||
        !aligned16(dy) || !aligned16(dx) || nvec > threads * vpt)
      return static_cast<int>(cudaErrorInvalidValue);
    e = rows_pass_any<T>(vpt, x, w, rstd, dy, dx, part, rows, n, ctas,
                         threads, s, nullptr);
  } else {
    rms_norm_bwd_any_kernel<T><<<ctas, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), rstd,
        static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, n);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw_kernel<T><<<(n + kRedCols - 1) / kRedCols, kRedWarps * 32, 0,
                          s>>>(part, static_cast<T*>(dw), ctas, n);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx (rows, n) and w, dw (n,) in one dtype; rstd (rows,) f32; part
// (ctas, n) f32 scratch. All contiguous. ctas, threads and vpt are the
// host plan's (ops/rms_norm.py `bwd_plan`): 1 <= ctas <= rows; threads a
// multiple of 32 up to 256; vpt 1, 2, 4 or 8 (at most 32 elements a
// thread) on the vector path (16-byte aligned tensors, n a multiple of the
// vector), vpt 0 on the general path.
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w,
                                const void* rstd, const void* dy, void* dx,
                                void* part, void* dw, int rows, int n,
                                int ctas, int threads, int vpt, int dtype,
                                void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0 || ctas <= 0 || ctas > rows || threads < 32 ||
      threads > kBwdMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(part);
  if (dtype == kF32)
    return launch_bwd<float>(x, w, r, dy, dx, pp, dw, rows, n, ctas, threads,
                             vpt, s);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(x, w, r, dy, dx, pp, dw, rows, n, ctas,
                                     threads, vpt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row CTAs of a vector-path plan that one SM holds (registers and
// shared memory, as the card reports them), or -1 for a plan the kernel
// does not take. Lets a test hold the plan's `per_sm` to the card.
extern "C" int ptt_rms_norm_bwd_fit(int n, int threads, int vpt,
                                    int dtype) {
  int fit = -1;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == kF32)
    e = rows_pass_any<float>(vpt, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, 0, n, 0, threads, nullptr,
                             &fit);
  else if (dtype == kBF16)
    e = rows_pass_any<__nv_bfloat16>(vpt, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, 0, n, 0,
                                     threads, nullptr, &fit);
  return e == cudaSuccess ? fit : -1;
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
