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
// Bound: bytes, 3 * rows * D * sizeof(T) (x and dy read, dx written) plus
// the scale and its gradient.  One block walks a contiguous run of rows.
// Where D is a multiple of the 16-byte vector and the pointers are aligned,
// each thread loads its fixed vectors of the row once, by 16-byte loads,
// into registers (at D = 4096 fp32 and 256 threads, four of x and four of
// dy); one block reduction carries both sums, (sum x^2, sum dy*scale*x),
// with one barrier a row; dx is written from the registers; the thread's
// columns' dscale partials stay in registers across the block's rows and
// are written once.  The vectors a thread holds are a template parameter
// (1, 2, 4 or 8); other shapes take the same kernel's generic
// instantiation, element by element.  A second kernel sums the blocks'
// partials column by column in a fixed order.  No atomics: the result is
// the same on every run.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
// the backward's blocks per SM: the register path holding up to 4 vectors
// a thread is held to the registers that let this many blocks of 256
// threads share an SM, and rt_rmsnorm_bwd_blocks launches one such wave
// (at 3, <fp32, 4 vectors> spilled and ran 5 % slower at (8192, 4096) on
// an H100 80GB HBM3 at 700 W; tools/bwd_variants.py)
constexpr int kBwdBlocksPerSM = 2;

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

// Sums a and b over the block: warp shuffles, one word per warp in red
// (a buffer of its own for every other row, so one barrier a row does),
// then every thread adds the warps' words in the same order.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float (&red)[2][kMaxThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
  for (int w = 0; w < nwarps; ++w) {
    sa += red[0][w];
    sb += red[1][w];
  }
  return make_float2(sa, sb);
}

// N elements of U at p as fp32, by 16-byte loads (p 16-byte aligned,
// N · sizeof(U) a multiple of 16).
template <typename U, int N>
__device__ __forceinline__ void load_f(const U* p, float (&out)[N]) {
  constexpr int PER = 16 / sizeof(U);
  static_assert(N % PER == 0, "whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < N / PER; ++i) {
    const Vec<U, PER> a = reinterpret_cast<const Vec<U, PER>*>(p)[i];
#pragma unroll
    for (int e = 0; e < PER; ++e) out[i * PER + e] = to_f(a.v[e]);
  }
}

// One block per run of rows [row0, row1): dx for each row, and this block's
// dscale partial (its rows' sum of dy * x * r) into partial[blockIdx.x].
// NV > 0, the register path: thread i holds 16-byte vectors i, i + blockDim,
// ..., NV of them, of x and dy, loads each row once (both sums in one block
// reduction, then dx from the registers) and keeps its columns' dscale
// partials in registers across the rows.  NV = 0, the generic path (D not
// a multiple of the vector, a misaligned pointer, D over the registers'
// reach): element by element, a second pass over the row for dx, the
// partials in shared memory.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(kMaxThreads, NV == 0 || NV > 4 ? 1 : kBwdBlocksPerSM)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int D, float eps) {
  constexpr int VEC = NV > 0 ? 16 / sizeof(T) : 1;
  constexpr int NR = NV > 0 ? NV : 1;
  extern __shared__ float ds_s[];         // generic path: this block's dscale partial
  __shared__ float red[2][2][kMaxThreads / 32];
  const int per = (rows + gridDim.x - 1) / gridDim.x;
  const int row0 = blockIdx.x * per;
  const int row1 = min(rows, row0 + per);

  float ds[NR][VEC];                      // register path: this thread's dscale partial
#pragma unroll
  for (int v = 0; v < NR; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ds[v][e] = 0.f;
  if constexpr (NV == 0)
    for (int i = threadIdx.x; i < D; i += blockDim.x) ds_s[i] = 0.f;

  for (int row = row0; row < row1; ++row) {
    const T* xr = x + static_cast<size_t>(row) * D;
    const T* gr = dy + static_cast<size_t>(row) * D;
    T* dr = dx + static_cast<size_t>(row) * D;
    float ss = 0.f, dot = 0.f;
    if constexpr (NV > 0) {
      float xv[NV][VEC], gv[NV][VEC];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = (threadIdx.x + v * blockDim.x) * VEC;
        if (c < D) {
          load_f<T, VEC>(xr + c, xv[v]);
          load_f<T, VEC>(gr + c, gv[v]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[v][e] = gv[v][e] = 0.f;
        }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = (threadIdx.x + v * blockDim.x) * VEC;
        if (c < D) {
          float sv[VEC];
          load_f<S, VEC>(scale + c, sv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            ss += xv[v][e] * xv[v][e];
            dot += gv[v][e] * sv[e] * xv[v][e];
          }
        }
      }
      const float2 tot = block_sum2(ss, dot, red[row & 1]);
      const float r = rsqrtf(tot.x / static_cast<float>(D) + eps);
      const float cc = tot.y * r * r * r / static_cast<float>(D);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = (threadIdx.x + v * blockDim.x) * VEC;
        if (c < D) {
          float sv[VEC];
          load_f<S, VEC>(scale + c, sv);
          Vec<T, VEC> o;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            o.v[e] = from_f<T>(r * gv[v][e] * sv[e] - xv[v][e] * cc);
            ds[v][e] += gv[v][e] * xv[v][e] * r;
          }
          *reinterpret_cast<Vec<T, VEC>*>(dr + c) = o;
        }
      }
    } else {
      for (int i = threadIdx.x; i < D; i += blockDim.x) {
        const float xv = to_f(xr[i]);
        ss += xv * xv;
        dot += to_f(gr[i]) * to_f(scale[i]) * xv;
      }
      const float2 tot = block_sum2(ss, dot, red[row & 1]);
      const float r = rsqrtf(tot.x / static_cast<float>(D) + eps);
      const float cc = tot.y * r * r * r / static_cast<float>(D);
      for (int i = threadIdx.x; i < D; i += blockDim.x) {
        const float xv = to_f(xr[i]), g = to_f(gr[i]);
        dr[i] = from_f<T>(r * g * to_f(scale[i]) - xv * cc);
        ds_s[i] += g * xv * r;            // column i is only ever this thread's
      }
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * D;
  if constexpr (NV > 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = (threadIdx.x + v * blockDim.x) * VEC;
      if (c < D)
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[c + e] = ds[v][e];
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) out[i] = ds_s[i];
  }
}

// dscale[j] = the sum of the blocks' partials: each of a block's 8 warps
// sums every 8th partial of 32 columns (one 128-byte read a partial), then
// the warps' sums are added in warp order.  The order is fixed, so the
// result is the same on every run.
constexpr int kDscaleWarps = 8;

template <typename S>
__global__ void __launch_bounds__(32 * kDscaleWarps)
rmsnorm_dscale_kernel(const float* __restrict__ partial, S* __restrict__ dscale,
                      int nblocks, int D) {
  __shared__ float part[kDscaleWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < D) {
#pragma unroll 4
    for (int b = warp; b < nblocks; b += kDscaleWarps)
      s += partial[static_cast<size_t>(b) * D + j];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kDscaleWarps; ++w) t += part[w][lane];
    dscale[j] = from_f<S>(t);
  }
}

template <typename T, typename S, int NV>
int run_bwd(const void* x, const void* scale, const void* dy, void* dx, void* partial,
            int rows, int D, int nblocks, float eps, int threads, cudaStream_t stream) {
  auto kernel = rmsnorm_bwd_kernel<T, S, NV>;
  const size_t smem = NV == 0 ? sizeof(float) * static_cast<size_t>(D) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nblocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, D, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               void* partial, int rows, int D, int nblocks, float eps, cudaStream_t stream) {
  // the register path: whole 16-byte vectors of x, dy, dx and the scale,
  // at most 8 a thread of 256 threads; the generic path otherwise
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = D / VEC;
  const bool vec_ok = D % VEC == 0 && nvec <= 8 * kMaxThreads && aligned16(x) &&
                      aligned16(dy) && aligned16(dx) && aligned16(scale);
#define RT_ARGS x, scale, dy, dx, partial, rows, D, nblocks, eps
  int rc;
  if (vec_ok) {
    const int nv = nvec <= kMaxThreads ? 1 : nvec <= 2 * kMaxThreads ? 2
                 : nvec <= 4 * kMaxThreads ? 4 : 8;
    const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
    switch (nv) {
      case 1: rc = run_bwd<T, S, 1>(RT_ARGS, threads, stream); break;
      case 2: rc = run_bwd<T, S, 2>(RT_ARGS, threads, stream); break;
      case 4: rc = run_bwd<T, S, 4>(RT_ARGS, threads, stream); break;
      default: rc = run_bwd<T, S, 8>(RT_ARGS, threads, stream); break;
    }
  } else {
    const int threads = D < kMaxThreads ? (D + 31) / 32 * 32 : kMaxThreads;
    rc = run_bwd<T, S, 0>(RT_ARGS, threads, stream);
  }
#undef RT_ARGS
  if (rc != cudaSuccess) return rc;
  rmsnorm_dscale_kernel<S><<<(D + 31) / 32, 32 * kDscaleWarps, 0, stream>>>(
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
  const int n = kBwdBlocksPerSM * sms;
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
