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
//
// Backward (rt_rmsnorm_bwd; the TPU kernel has none: the reference trains
// through plain jnp, and the port's training path on the card needs one).
// With r = rsqrt(mean(x^2) + eps) recomputed from x (nothing is saved):
//   dx = r * (dy * scale) - x * r^3 / D * sum_j(dy_j * scale_j * x_j)
//   dscale_j = sum over rows of dy_j * x_j * r.
// One block walks a contiguous run of rows: per row one block reduction of
// (sum x^2, sum dy*scale*x), then dx; each thread keeps its own columns'
// dscale partial sums in shared memory.  A second kernel sums the blocks'
// partials column by column in block order.  No atomics: the result is the
// same on every run.  Bound: bytes, 3 * rows * D * sizeof(T) (x and dy read,
// dx written) plus the scale and its gradient.
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

// One block per run of rows [row0, row1): dx for each row, and this block's
// dscale partial (its rows' sum of dy * x * r) into partial[blockIdx.x].
template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int D, float eps) {
  extern __shared__ float ds[];           // D floats: this block's dscale partial
  __shared__ float red[2][kMaxThreads / 32];
  const int per = (rows + gridDim.x - 1) / gridDim.x;
  const int row0 = blockIdx.x * per;
  const int row1 = min(rows, row0 + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int i = threadIdx.x; i < D; i += blockDim.x) ds[i] = 0.f;

  for (int row = row0; row < row1; ++row) {
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* gr = dy + static_cast<size_t>(row) * D;
    T* dr = dx + static_cast<size_t>(row) * D;
    float ss = 0.f, dot = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xv = to_f(xr[i]);
      ss += xv * xv;
      dot += to_f(gr[i]) * to_f(scale[i]) * xv;
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = dot;
    }
    __syncthreads();
    if (warp == 0) {
      float a = lane < nwarps ? red[0][lane] : 0.f;
      float b = lane < nwarps ? red[1][lane] : 0.f;
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        red[0][0] = a;
        red[1][0] = b;
      }
    }
    __syncthreads();
    const float r = rsqrtf(red[0][0] / static_cast<float>(D) + eps);
    const float c = red[1][0] * r * r * r / static_cast<float>(D);
    __syncthreads();                      // red is rewritten by the next row
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xv = to_f(xr[i]), g = to_f(gr[i]);
      dr[i] = from_f<T>(r * g * to_f(scale[i]) - xv * c);
      ds[i] += g * xv * r;                // column i is only ever this thread's
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) out[i] = ds[i];
}

// dscale[j] = sum over the blocks' partials, in block order.
template <typename S>
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale,
                                      int nblocks, int D) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += partial[static_cast<size_t>(b) * D + j];
  dscale[j] = from_f<S>(s);
}

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               void* partial, int rows, int D, int nblocks, float eps, cudaStream_t stream) {
  auto kernel = rmsnorm_bwd_kernel<T, S>;
  const size_t smem = sizeof(float) * static_cast<size_t>(D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((D + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  kernel<<<nblocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_kernel<S><<<(D + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<S*>(dscale), nblocks, D);
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

// The blocks rt_rmsnorm_bwd runs for ``rows`` rows: its partial buffer
// holds that many rows of D floats.
extern "C" int rt_rmsnorm_bwd_blocks(int rows) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n = 4 * sms;
  return rows < n ? rows : n;
}

// x, dy, dx: (rows, D) contiguous in x_dtype; scale, dscale: (D,) in
// scale_dtype (fp32 or x's); partial: nblocks x D fp32 scratch, nblocks from
// rt_rmsnorm_bwd_blocks(rows).  Returns a cudaError_t, or RT_UNSUPPORTED.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                              void* dscale, void* partial, int rows, int D, int nblocks,
                              float eps, int x_dtype, int scale_dtype, void* stream) {
  if (rows <= 0 || D <= 0 || nblocks <= 0 || nblocks > rows) return RT_UNSUPPORTED;
  if (static_cast<size_t>(D) * sizeof(float) > 227 * 1024) return RT_UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool s32 = scale_dtype == RT_F32;
  if (!s32 && scale_dtype != x_dtype) return RT_UNSUPPORTED;
#define RT_ARGS x, scale, dy, dx, dscale, partial, rows, D, nblocks, eps, s
  switch (x_dtype) {
    case RT_F32:
      return launch_bwd<float, float>(RT_ARGS);
    case RT_BF16:
      return s32 ? launch_bwd<__nv_bfloat16, float>(RT_ARGS)
                 : launch_bwd<__nv_bfloat16, __nv_bfloat16>(RT_ARGS);
    case RT_F16:
      return s32 ? launch_bwd<__half, float>(RT_ARGS) : launch_bwd<__half, __half>(RT_ARGS);
  }
#undef RT_ARGS
  return RT_UNSUPPORTED;
}
