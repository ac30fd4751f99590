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
// here blocks run in parallel, so the rows are cut into `nblk` contiguous
// blocks, one CTA each. A CTA walks its rows one at a time: a first sweep
// sums g * x over the row (warp shuffles, one shared step) and adds
// dy * x * r into a shared f32 row of dw partial sums in which each column
// belongs to one thread (no race, no atomics); a second sweep over the row
// (now in L1/L2) writes dx. Each CTA then writes its partial row to
// `part[b]`, and a second small kernel sums the nblk partials of each
// column in a fixed order: the result does not depend on scheduling.

template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float t = lane < THREADS / 32 ? red[lane] : 0.f;
  t = warp_sum(t);  // every warp reduces the same values
  __syncthreads();  // red is rewritten by the next call
  return t;
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
    rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ rstd,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, int rows, int n, int per,
                        bool vec) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float acc[];  // [n]: this CTA's dw partial sums
  __shared__ float red[THREADS / 32];
  for (int i = threadIdx.x; i < n; i += THREADS) acc[i] = 0.f;
  __syncthreads();  // the sweeps below own columns in another pattern
  const int r_begin = blockIdx.x * per;
  const int r_end = min(rows, r_begin + per);
  const float inv_n = 1.f / static_cast<float>(n);

  for (int row = r_begin; row < r_end; ++row) {
    const T* xr = x + static_cast<size_t>(row) * n;
    const T* dyr = dy + static_cast<size_t>(row) * n;
    T* dxr = dx + static_cast<size_t>(row) * n;
    const float r = rstd[row];
    float gx = 0.f;
    if (vec) {
      for (int i = threadIdx.x * V; i < n; i += THREADS * V) {
        float xv[V], dv[V], wv[V];
        load_vec(xr + i, xv);
        load_vec(dyr + i, dv);
        load_vec(w + i, wv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          gx = fmaf(dv[k] * wv[k], xv[k], gx);
          acc[i + k] += dv[k] * xv[k] * r;
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const float xv = to_f32(xr[i]), dv = to_f32(dyr[i]);
        gx = fmaf(dv * to_f32(w[i]), xv, gx);
        acc[i] += dv * xv * r;
      }
    }
    const float c = r * r * r * block_sum<THREADS>(gx, red) * inv_n;
    if (vec) {
      for (int i = threadIdx.x * V; i < n; i += THREADS * V) {
        float xv[V], dv[V], wv[V];
        load_vec(xr + i, xv);
        load_vec(dyr + i, dv);
        load_vec(w + i, wv);
#pragma unroll
        for (int k = 0; k < V; ++k) xv[k] = dv[k] * wv[k] * r - xv[k] * c;
        store_vec(dxr + i, xv);
      }
    } else {
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const float xv = to_f32(xr[i]);
        dxr[i] = from_f32<T>(to_f32(dyr[i]) * to_f32(w[i]) * r - xv * c);
      }
    }
  }
  float* pr = part + static_cast<size_t>(blockIdx.x) * n;
  if (vec) {
    for (int i = threadIdx.x * V; i < n; i += THREADS * V)
#pragma unroll
      for (int k = 0; k < V; ++k) pr[i + k] = acc[i + k];
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) pr[i] = acc[i];
  }
}

// dw[j] = sum over b of part[b][j], b in order.
template <typename T>
__global__ void __launch_bounds__(256)
    rms_norm_dw_kernel(const float* __restrict__ part, T* __restrict__ dw,
                       int nblk, int n) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[static_cast<size_t>(b) * n + j];
  dw[j] = from_f32<T>(s);
}

template <typename T, int THREADS>
static int launch_bwd(const void* x, const void* w, const float* rstd,
                      const void* dy, void* dx, float* part, void* dw,
                      int rows, int n, int nblk, cudaStream_t stream) {
  const bool vec = (n % Vec<T>::N == 0) && aligned16(x) && aligned16(w) &&
                   aligned16(dy) && aligned16(dx);
  const size_t smem = sizeof(float) * static_cast<size_t>(n);
  auto kernel = rms_norm_bwd_kernel<T, THREADS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int per = (rows + nblk - 1) / nblk;
  kernel<<<nblk, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, n, per,
      vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(dw), nblk, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_bwd_any(const void* x, const void* w, const float* rstd,
                          const void* dy, void* dx, float* part, void* dw,
                          int rows, int n, int nblk, cudaStream_t stream) {
  if (n >= 256 * Vec<T>::N)
    return launch_bwd<T, 256>(x, w, rstd, dy, dx, part, dw, rows, n, nblk,
                              stream);
  return launch_bwd<T, 128>(x, w, rstd, dy, dx, part, dw, rows, n, nblk,
                            stream);
}

// x, dy, dx (rows, n) and w, dw (n,) in one dtype; rstd (rows,) f32; part
// (nblk, n) f32 scratch, 1 <= nblk <= rows. All contiguous.
extern "C" int ptt_rms_norm_bwd(const void* x, const void* w,
                                const void* rstd, const void* dy, void* dx,
                                void* part, void* dw, int rows, int n,
                                int nblk, int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0 || nblk <= 0 || nblk > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(part);
  if (dtype == kF32)
    return launch_bwd_any<float>(x, w, r, dy, dx, pp, dw, rows, n, nblk, s);
  if (dtype == kBF16)
    return launch_bwd_any<__nv_bfloat16>(x, w, r, dy, dx, pp, dw, rows, n,
                                         nblk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
