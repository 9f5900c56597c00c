// Shared helpers of the port's CUDA kernels: dtype codes, conversions, and
// warp reductions.  Built with PyTorch's cpp_extension flags, which forbid
// implicit __half / __nv_bfloat16 conversions, so every conversion goes
// through an intrinsic.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum RtDtype { RT_F32 = 0, RT_BF16 = 1, RT_F16 = 2 };

// returned by a launcher for an argument the kernel does not take
constexpr int RT_UNSUPPORTED = -1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
