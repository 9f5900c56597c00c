// RWKV6 WKV, one decode step (S == 1): the streaming kernel that
// kernels/wkv6.py runs for S == 1, beside the chunked kernel of wkv6.cu.
//
// Replaces repro/kernels/wkv6.py::wkv6_pallas (the pl.pallas_call at
// wkv6.py:66) at S == 1, where the reference's ops.wkv6 takes its step
// oracle.  Per (batch, head), with the state S0 (K, V) fp32:
//   y_v      = sum_c r_c (S0[c][v] + u_c k_c v_v)
//   S1[c][v] = e^{w_c} S0[c][v] + k_c v_v
// The work is reading and writing the state: at rwkv6-1.6b (B = 8, H = 32,
// K = V = 64) 8.4 MB of its 8.7 MB, 0.0026 ms at 3.35 TB/s: bytes.
//
// y reduces over the state's rows c, not along them (as SSD's decode step
// does), so a thread owns 4 columns (one 16-byte piece) of K / 16 rows:
// rows c = g + 16 i of row group g.  A block of 4 V threads holds one
// (batch, head): V / 4 column groups by 16 row groups, K · V / (4 V) = K / 4
// floats a thread (16 at K = 64).  Neighbouring threads take neighbouring
// columns, so a warp's loads and stores of the state are whole rows.  The
// sum over c goes by shuffles across the row groups of a warp, then through
// shared memory across its warps.  Each state element is read and written
// by the one thread that owns it, after it has read it, so the new state
// may overwrite the old in place (s0 == sf).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int GROUPS = 16;            // row groups of a block

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 a) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = a;
  } else {
    p[0] = from_f<T>(a.x); p[1] = from_f<T>(a.y);
    p[2] = from_f<T>(a.z); p[3] = from_f<T>(a.w);
  }
}

template <typename T, int K, int V>
__global__ void __launch_bounds__(4 * V)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* s0, T* __restrict__ y,
                 float* sf, int H) {
  constexpr int CG = V / 4;           // column groups
  constexpr int RPT = K / GROUPS;     // rows a thread owns
  constexpr int WARPS = 4 * V / 32;
  constexpr int LANES = CG < 32 ? CG : 32;   // lanes holding a warp's sums
  static_assert(K % GROUPS == 0 && 4 * V % 32 == 0, "bad K, V");
  __shared__ float4 part[WARPS][CG];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % CG, g = tid / CG;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const T* rp = r + bh * K;
  const T* kp = k + bh * K;
  const float* wp = w + bh * K;
  const float* up = u + static_cast<size_t>(h) * K;
  const float4 vv = load4(v + bh * V + 4 * cg);

  // read every owned row of the state first, then compute and write
  float4 st[RPT];
  const size_t base = bh * K * V + 4 * cg;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    st[i] = s0 ? *reinterpret_cast<const float4*>(s0 + base + static_cast<size_t>(g + GROUPS * i) * V)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int c = g + GROUPS * i;
    const float rc = to_f(rp[c]), kc = to_f(kp[c]);
    const float decay = expf(wp[c]), bonus = up[c] * kc;
    float4& s = st[i];
    acc.x += rc * (s.x + bonus * vv.x);
    acc.y += rc * (s.y + bonus * vv.y);
    acc.z += rc * (s.z + bonus * vv.z);
    acc.w += rc * (s.w + bonus * vv.w);
    s.x = decay * s.x + kc * vv.x;
    s.y = decay * s.y + kc * vv.y;
    s.z = decay * s.z + kc * vv.z;
    s.w = decay * s.w + kc * vv.w;
    *reinterpret_cast<float4*>(sf + base + static_cast<size_t>(c) * V) = s;
  }
  // lanes cg, cg + CG, ... of a warp hold the same columns
#pragma unroll
  for (int o = CG; o < 32; o <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, o);
    acc.y += __shfl_xor_sync(kFull, acc.y, o);
    acc.z += __shfl_xor_sync(kFull, acc.z, o);
    acc.w += __shfl_xor_sync(kFull, acc.w, o);
  }
  if (lane < LANES) part[warp][cg] = acc;
  __syncthreads();
  if (tid < CG) {
    float4 sum = part[0][tid];
#pragma unroll
    for (int j = 1; j < WARPS; ++j) {
      const float4 p = part[j][tid];
      sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
    }
    store4(y + bh * V + 4 * tid, sum);
  }
}

template <typename T, int K, int V>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, void* y, float* sf, int B, int H, cudaStream_t stream) {
  wkv6_step_kernel<T, K, V><<<dim3(H, B), 4 * V, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      s0, static_cast<T*>(y), sf, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_v(const void* r, const void* k, const void* v, const float* w, const float* u,
             const float* s0, void* y, float* sf, int B, int H, int V, cudaStream_t s) {
  switch (V) {
    case 16: return launch<T, K, 16>(r, k, v, w, u, s0, y, sf, B, H, s);
    case 32: return launch<T, K, 32>(r, k, v, w, u, s0, y, sf, B, H, s);
    case 64: return launch<T, K, 64>(r, k, v, w, u, s0, y, sf, B, H, s);
    case 128: return launch<T, K, 128>(r, k, v, w, u, s0, y, sf, B, H, s);
  }
  return RT_UNSUPPORTED;
}

template <typename T>
int launch_kv(const void* r, const void* k, const void* v, const float* w, const float* u,
              const float* s0, void* y, float* sf, int B, int H, int K, int V,
              cudaStream_t s) {
  switch (K) {
    case 16: return launch_v<T, 16>(r, k, v, w, u, s0, y, sf, B, H, V, s);
    case 32: return launch_v<T, 32>(r, k, v, w, u, s0, y, sf, B, H, V, s);
    case 64: return launch_v<T, 64>(r, k, v, w, u, s0, y, sf, B, H, V, s);
    case 128: return launch_v<T, 128>(r, k, v, w, u, s0, y, sf, B, H, V, s);
  }
  return RT_UNSUPPORTED;
}

}  // namespace

// One decode step.  r, k: (B, 1, H, K), v, y: (B, 1, H, V), contiguous, dtype
// `dtype` (fp32 or bf16); w: (B, 1, H, K), u: (H, K), s0 (may be null:
// zeros) and sf: (B, H, K, V), all fp32 and contiguous; v, y (fp32), s0 and
// sf 16-byte aligned; sf may be s0.  Returns a cudaError_t, or
// RT_UNSUPPORTED for what the kernel does not take (K or V outside
// {16, 32, 64, 128}, another dtype, a grid dimension over its limit).
extern "C" int rt_wkv6_step(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* s0, void* y, void* sf, int B, int H,
                            int K, int V, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || B > 65535) return RT_UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sff = static_cast<float*>(sf);
  switch (dtype) {
    case RT_F32: return launch_kv<float>(r, k, v, wf, uf, s0f, y, sff, B, H, K, V, s);
    case RT_BF16:
      return launch_kv<__nv_bfloat16>(r, k, v, wf, uf, s0f, y, sff, B, H, K, V, s);
  }
  return RT_UNSUPPORTED;
}
