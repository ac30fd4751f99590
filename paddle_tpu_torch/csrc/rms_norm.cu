// RMSNorm forward (K1) for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/rms_norm.py, `_rms_fwd` -> `_fwd_kernel`
// (row-blocked Pallas kernel: r = rsqrt(mean(x^2) + eps), y = x * r * w in
// f32, r saved per row for the backward).
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

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
