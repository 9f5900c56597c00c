// Forward flash attention, causal or full, with grouped KV heads (GQA).
//
// Port of repro/kernels/flash.py::flash_attention (_flash_kernel).  The TPU
// kernel walks a sequential KV grid axis with the running max, denominator
// and fp32 accumulator in VMEM scratch.  Here one block owns one (batch,
// query head, 64-row query tile) and walks the KV tiles in a loop, so the
// online-softmax state lives in registers:
//   * the query tile and each 32-row K and V tile are staged in shared memory
//     as fp32 (74 KB at h = 128, so the launch opts into dynamic shared
//     memory above the 48 KB static limit);
//   * four adjacent lanes own one query row: each computes 8 of the tile's
//     32 scores and h/4 of the row's output columns, so the accumulator is
//     32 floats a thread at h = 128 (28 at zamba2-7b's h = 112) and nothing
//     spills;
//   * the row max and denominator combine over those four lanes with warp
//     shuffles; the probabilities go through shared memory to the P @ V loop,
//     and a __syncwarp suffices because a row's lanes share a warp;
//   * KV tiles past the last row of a causal query tile are never loaded,
//     and rows or keys past Sq / Sk are masked in the kernel, so no length
//     has to be a block multiple.
// The constants are the TPU kernel's: masked scores -1e30, the denominator
// clamped at 1e-20, scores scaled by 1/sqrt(h).
//
// Bound on the H100: operations.  At llama3-8b prefill (S = 512, h = 128) the
// kernel does about 4 * h flops per (query, key) pair against 4 * h * 4 bytes
// per row of q, k, v, o, far above the card's ~20 fp32 flops per byte.  This
// first version runs on the CUDA cores in fp32, so its ceiling is the 67
// TFLOP/s fp32 rate; shared-memory traffic (about one load per FMA) keeps it
// well below that.  Tensor cores (wgmma, TMA) come later.
#include "common.cuh"

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per KV tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;   // lanes per query row (adjacent lanes)
constexpr int CPT = BK / TPR;       // scores per lane per KV tile
constexpr float kNegInf = -1e30f;
constexpr float kDenomFloor = 1e-20f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, int causal, float scale) {
  static_assert(HD % TPR == 0, "head dim must split over a row's lanes");
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x (HD + 1), padded rows
  float* Ks = Qs + BQ * (HD + 1);      // BK x (HD + 1), padded rows
  float* Vs = Ks + BK * (HD + 1);      // BK x HD
  float* Ps = Vs + BK * HD;            // BQ x (BK + 1), padded rows

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int r = threadIdx.x / TPR;     // query row of this lane in the tile
  const int cg = threadIdx.x % TPR;    // its column group
  const int qpos = q0 + r;

  const size_t q_stride = static_cast<size_t>(Hq) * HD;    // between positions
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const T* qb = q + (static_cast<size_t>(b) * Sq * Hq + hq) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  T* ob = o + (static_cast<size_t>(b) * Sq * Hq + hq) * HD;

  for (int e = threadIdx.x; e < BQ * HD; e += THREADS) {
    const int rr = e / HD, d = e % HD;
    const int s = q0 + rr;
    Qs[rr * (HD + 1) + d] = s < Sq ? to_f(qb[s * q_stride + d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[HD / TPR];
#pragma unroll
  for (int i = 0; i < HD / TPR; ++i) acc[i] = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile is consumed; Qs is loaded
    for (int e = threadIdx.x; e < BK * HD; e += THREADS) {
      const int rr = e / HD, d = e % HD;
      const int s = k0 + rr;
      const bool in = s < Sk;
      Ks[rr * (HD + 1) + d] = in ? to_f(kb[s * kv_stride + d]) : 0.f;
      Vs[rr * HD + d] = in ? to_f(vb[s * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) sc[j] = 0.f;
    const float* qr = Qs + r * (HD + 1);
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[j] += qv * Ks[(cg + TPR * j) * (HD + 1) + d];
    }

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kpos = k0 + cg + TPR * j;
      const bool ok = kpos < Sk && (!causal || kpos <= qpos);
      sc[j] = ok ? sc[j] * scale : kNegInf;
      mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    float* pr = Ps + r * (BK + 1);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      pr[cg + TPR * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();      // the row's probabilities are in Ps

#pragma unroll
    for (int i = 0; i < HD / TPR; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const float* vr = Vs + c * HD + cg;
#pragma unroll
      for (int i = 0; i < HD / TPR; ++i) acc[i] += p * vr[TPR * i];
    }
  }

  if (qpos < Sq) {
    const float den = fmaxf(l, kDenomFloor);
    T* orow = ob + qpos * q_stride + cg;
#pragma unroll
    for (int i = 0; i < HD / TPR; ++i) orow[TPR * i] = from_f<T>(acc[i] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_h(const void* q, const void* k, const void* v, void* o, int B, int Sq,
             int Sk, int Hq, int Hkv, int h, int causal, float scale,
             cudaStream_t s) {
  switch (h) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 112: return launch<T, 112>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, scale, s);
  }
  return RT_UNSUPPORTED;
}

}  // namespace

// q, o: (B, Sq, Hq, h); k, v: (B, Sk, Hkv, h); all contiguous, one dtype.
// Returns a cudaError_t, or RT_UNSUPPORTED for shapes the kernel does not
// take (h outside {16, 32, 64, 112, 128}, Hq not a multiple of Hkv, a grid
// dimension over its limit).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int Sq, int Sk, int Hq, int Hkv,
                                  int h, int causal, float scale, int dtype,
                                  void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535)
    return RT_UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RT_F32: return launch_h<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, h, causal, scale, s);
    case RT_BF16: return launch_h<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, h, causal, scale, s);
    case RT_F16: return launch_h<__half>(q, k, v, o, B, Sq, Sk, Hq, Hkv, h, causal, scale, s);
  }
  return RT_UNSUPPORTED;
}
