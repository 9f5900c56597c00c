// Shared helpers of the port's CUDA kernels: dtype codes, conversions, warp
// reductions, the fp32-exact TF32 tensor-core product (3xTF32 on
// mma.sync.m16n8k8), cp.async, and mbarriers with 1-D bulk copies (TMA).
// Built with PyTorch's cpp_extension flags, which forbid implicit __half /
// __nv_bfloat16 conversions, so every conversion goes through an intrinsic.
#pragma once
#include <cstdint>
#include <type_traits>

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

// x = big + small: big = x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds every finite x, which sm_90 emulates in five
// instructions; the add and mask take two), small = x − big exactly in fp32,
// which the TF32 MMA reads truncated to its top 19 bits (a 2^-21 relative
// error of x)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a·b for one m16n8k8 tile, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b to fp32 accuracy: the small terms first, then big·big
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], float2 b) {
  uint32_t b_big[2], b_small[2];
  split(b.x, b_big[0], b_small[0]);
  split(b.y, b_big[1], b_small[1]);
  mma(c, a_small, b_big);
  mma(c, a_big, b_small);
  mma(c, a_big, b_big);
}

// 16 bytes from global to shared memory; zeros where !valid (src must still
// be a valid address).  The caller commits the group.
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// two adjacent outputs, as one 8-byte store when fp32
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = from_f<T>(a);
    p[1] = from_f<T>(b);
  }
}

// mbarriers in shared memory, and the 1-D bulk copy (TMA) that completes
// on one: a barrier inited with count 1 completes its phase when one
// thread has armed it with mbar_expect_tx and that many bytes have landed.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// makes the inits visible to the bulk copies; a barrier follows before use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// waits until the barrier's phase of the given parity (0 for its first,
// then 1, 0, ...) has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the TMA; completes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
