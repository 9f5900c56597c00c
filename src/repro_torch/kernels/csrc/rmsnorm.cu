// RMSNorm over the last dim: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Port of repro/kernels/rmsnorm.py::rmsnorm_pallas (_rmsnorm_kernel), which
// streams (256, D) row tiles through VMEM and fuses the mean-square reduce
// with the scale.  Here one block owns one row: its threads read the row with
// 16-byte loads where D and the pointers allow, sum the squares in fp32 (warp
// shuffles, then one word per warp in shared memory), and make a second pass
// that scales and stores in x's dtype.  The second read of the row hits L1/L2,
// so device memory sees each input byte once and each output byte once.
//
// Bound on the H100: bytes.  Two flops a byte is far below the card's
// ~20 fp32 flops per byte of HBM bandwidth, so the kernel can at best
// stream 2 * rows * D * sizeof(T) bytes at 3.35 TB/s.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, int D, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const int nvec = D / VEC;
  const Vec<T, VEC>* xv = reinterpret_cast<const Vec<T, VEC>*>(xr);
  Vec<T, VEC>* yv = reinterpret_cast<Vec<T, VEC>*>(yr);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec<T, VEC> a = xv[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = to_f(a.v[j]);
      ss += f * f;
    }
  }

  __shared__ float partial[kMaxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float t = lane < nwarps ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) partial[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / static_cast<float>(D) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec<T, VEC> a = xv[i];
    Vec<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // same order as the reference: (x * r) * scale
      o.v[j] = from_f<T>(to_f(a.v[j]) * r * to_f(scale[i * VEC + j]));
    }
    yv[i] = o;
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int rows, int D,
           float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_ok = D % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int nvec = vec_ok ? D / VEC : D;
  int threads = ((nvec + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* yp = static_cast<T*>(y);
  if (vec_ok)
    rmsnorm_kernel<T, S, VEC><<<rows, threads, 0, stream>>>(xp, sp, yp, D, eps);
  else
    rmsnorm_kernel<T, S, 1><<<rows, threads, 0, stream>>>(xp, sp, yp, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, D) contiguous, dtype x_dtype; scale: (D,), dtype scale_dtype,
// which is fp32 or x's dtype.  Returns a cudaError_t, or RT_UNSUPPORTED.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* y, int rows,
                          int D, float eps, int x_dtype, int scale_dtype,
                          void* stream) {
  if (rows <= 0 || D <= 0) return RT_UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool s32 = scale_dtype == RT_F32;
  if (!s32 && scale_dtype != x_dtype) return RT_UNSUPPORTED;
  switch (x_dtype) {
    case RT_F32:
      return launch<float, float>(x, scale, y, rows, D, eps, s);
    case RT_BF16:
      return s32 ? launch<__nv_bfloat16, float>(x, scale, y, rows, D, eps, s)
                 : launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, D, eps, s);
    case RT_F16:
      return s32 ? launch<__half, float>(x, scale, y, rows, D, eps, s)
                 : launch<__half, __half>(x, scale, y, rows, D, eps, s);
  }
  return RT_UNSUPPORTED;
}
