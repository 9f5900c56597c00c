// Backward flash attention, causal or full, with grouped KV heads (GQA), on
// the fp32 CUDA cores.
//
// The TPU kernel it pairs with, repro/kernels/flash.py::flash_attention (the
// pl.pallas_call at flash.py:79), has no backward: the reference trains
// through plain jnp attention.  The port's training path runs its forward
// kernel (flash.cu) on the card, so it needs this one.  From q, k, v, the
// forward's output o and its per-row log-sum-exp lse, and the output's
// gradient dO, with P = exp(scale * q kᵀ - lse) recomputed tile by tile:
//   D  = rowsum(dO ∘ O)                    (flash_bwd_dot_kernel)
//   dV = Pᵀ dO,  dK = scale * dSᵀ Q        (flash_bwd_dkdv_kernel)
//   dQ = scale * dS K                      (flash_bwd_dq_kernel)
// where dP = dO Vᵀ and dS = P ∘ (dP - D).  Nothing of size Sq x Sk is ever
// written to device memory.
//
// Layout.  dK and dV are owned by one block per (batch, KV head, 64-key
// tile), which walks the query tiles of all G query heads of its KV head
// and sums into registers: GQA's sum over the group needs no second pass
// and no atomics.  dQ is owned by one block per (batch, query head, 64-row
// query tile), which walks the key tiles.  So every gradient is a plain
// sum in a fixed order, the same on every run (no fp32 atomics).  S and dP
// are recomputed in both kernels.
//
// Bound on the H100: operations.  Five products of 2·h flops per (query,
// key) pair the mask keeps (QKᵀ, dO Vᵀ, Pᵀ dO, dSᵀ Q, dS K) against
// 4 · 4 · h bytes per row of q, k, v, o, dO read and dq, dk, dv written.
// This first kernel runs them on the CUDA cores in fp32 (67 TFLOP/s), and
// recomputes QKᵀ and dO Vᵀ in the dQ kernel (seven products done for five).
// Its design is simple: 256 threads per block in a 16 x 16 grid, each
// owning a 4 x 4 tile of S and dP, read from shared-memory tiles with
// 16-byte loads (rows padded to h + 4 floats, so the loads of 16 rows hit
// distinct banks), then 4 x h/16 outputs of dK and dV (or dQ).  The tensor
// cores (3xTF32 on mma.sync, or wgmma) are later work.
//
// Lengths need not be tile multiples: rows past Sq and keys past Sk are
// zero-filled and masked.  The causal mask counts query and key positions
// from 0, as the forward's does.
#include "common.cuh"

namespace {

constexpr int BQ = 64;              // query rows per tile
constexpr int BK = 64;              // keys per tile
constexpr int THREADS = 256;        // a 16 x 16 grid
constexpr int LDP = BK + 4;         // pitch of the P and dS tiles, in floats
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tiles {                      // in floats
  static constexpr int LD = HD + 4; // 16-byte rows; 16 rows' float4s on distinct banks
  static constexpr int T = 64 * LD; // one tile of Q, dO, K or V
};

// ROWS rows of HD elements, row r at src + (row0 + r) * stride, into dst
// (pitch LD) as fp32; rows at or past n are zeros.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride,
                                          int row0, int n) {
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    dst[r * LD + c] = row0 + r < n ? to_f(src[static_cast<size_t>(row0 + r) * stride + c])
                                   : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// S = Q Kᵀ and dP = dO Vᵀ for this thread's rows ty + 16a and keys tx + 16c,
// then P = exp(scale·S - lse) under the mask and dS = P ∘ (dP - D).
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, const float* lse_s, const float* D_s,
                                       int q0, int k0, int Sq, int Sk, int causal, float sl2,
                                       float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int LD = Tiles<HD>::LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * LD + d);
      da[a] = *reinterpret_cast<const float4*>(dOs + (ty + 16 * a) * LD + d);
      kb[a] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * a) * LD + d);
      vb[a] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * a) * LD + d);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] += dot4(qa[a], kb[c]);
        dp[a][c] += dot4(da[a], vb[c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a, qpos = q0 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + tx + 16 * c;
      const bool ok = qpos < Sq && kpos < Sk && (!causal || kpos <= qpos);
      p[a][c] = ok ? exp2f(s[a][c] * sl2 - lse_s[i]) : 0.f;
      ds[a][c] = p[a][c] * (dp[a][c] - D_s[i]);
    }
  }
}

// lse (natural log) in log2 units and D for the query tile at q0 of head hq.
__device__ __forceinline__ void load_rows_stats(float* lse_s, float* D_s, const float* lse,
                                                const float* Dv, size_t base, int q0, int Sq) {
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const bool in = q0 + i < Sq;
    lse_s[i] = in ? lse[base + q0 + i] * kLog2e : 0.f;
    D_s[i] = in ? Dv[base + q0 + i] : 0.f;
  }
}

// D[b, hq, i] = sum_d dO[b, i, hq, d] * O[b, i, hq, d]: one warp per row.
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                                     float* __restrict__ Dv, int B, int Sq, int Hq, int h) {
  const size_t w = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= static_cast<size_t>(B) * Sq * Hq) return;
  const T* orow = o + w * h;
  const T* grow = dO + w * h;
  float s = 0.f;
  for (int c = lane; c < h; c += 32) s += to_f(orow[c]) * to_f(grow[c]);
  s = warp_sum(s);
  if (lane == 0) {
    const size_t hq = w % Hq, i = (w / Hq) % Sq, b = w / (static_cast<size_t>(Hq) * Sq);
    Dv[(b * Hq + hq) * Sq + i] = s;
  }
}

// dK and dV for the keys [k0, k0 + BK) of KV head hk, summed over the G
// query heads of its group and every query tile the mask lets see them.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ Dv,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq,
                      int Hkv, int causal, float scale) {
  using L = Tiles<HD>;
  constexpr int LD = L::LD, NE = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::T;
  float* Qs = Vs + L::T;
  float* dOs = Qs + L::T;
  float* Ps = dOs + L::T;           // BQ x LDP
  float* dSs = Ps + BQ * LDP;       // BQ x LDP
  float* lse_s = dSs + BQ * LDP;    // BQ
  float* D_s = lse_s + BQ;          // BQ

  const int k0 = blockIdx.x * BK;   // causal: the short tiles (late keys) last
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float sl2 = scale * kLog2e;
  const size_t q_stride = static_cast<size_t>(Hq) * HD;
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;

  load_tile<T, HD, LD>(Ks, k + kv_base, kv_stride, k0, Sk);
  load_tile<T, HD, LD>(Vs, v + kv_base, kv_stride, k0, Sk);

  float dK[4][NE], dV[4][NE];       // keys 4 ty + c, columns tx + 16 e
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < NE; ++e) dK[c][e] = dV[c][e] = 0.f;

  const int nqt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const size_t q_base = (static_cast<size_t>(b) * Sq * Hq + hq) * HD;
    const size_t row_base = (static_cast<size_t>(b) * Hq + hq) * Sq;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();              // the previous tile's readers are done
      load_tile<T, HD, LD>(Qs, q + q_base, q_stride, q0, Sq);
      load_tile<T, HD, LD>(dOs, dO + q_base, q_stride, q0, Sq);
      load_rows_stats(lse_s, D_s, lse, Dv, row_base, q0, Sq);
      __syncthreads();

      float p[4][4], ds[4][4];
      scores<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, Sq, Sk, causal, sl2, p, ds);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Ps[(ty + 16 * a) * LDP + tx + 16 * c] = p[a][c];
          dSs[(ty + 16 * a) * LDP + tx + 16 * c] = ds[a][c];
        }
      __syncthreads();

      // dV[j] += P[i, j] dO[i], dK[j] += dS[i, j] Q[i] over the tile's rows
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + i * LDP + 4 * ty);
        const float4 d4 = *reinterpret_cast<const float4*>(dSs + i * LDP + 4 * ty);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dj[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float go = dOs[i * LD + tx + 16 * e];
          const float qv = Qs[i * LD + tx + 16 * e];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dV[c][e] += pj[c] * go;
            dK[c][e] += dj[c] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int kpos = k0 + 4 * ty + c;
    if (kpos < Sk) {
      T* dkr = dk + kv_base + static_cast<size_t>(kpos) * kv_stride;
      T* dvr = dv + kv_base + static_cast<size_t>(kpos) * kv_stride;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        dkr[tx + 16 * e] = from_f<T>(dK[c][e] * scale);
        dvr[tx + 16 * e] = from_f<T>(dV[c][e]);
      }
    }
  }
}

// dQ for the query rows [q0, q0 + BQ) of head hq, over every key tile the
// mask lets them see.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ Dv,
                    T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
                    float scale) {
  using L = Tiles<HD>;
  constexpr int LD = L::LD, NE = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::T;
  float* Ks = dOs + L::T;
  float* Vs = Ks + L::T;
  float* dSs = Vs + L::T;           // BQ x LDP
  float* lse_s = dSs + BQ * LDP;
  float* D_s = lse_s + BQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float sl2 = scale * kLog2e;
  const size_t q_stride = static_cast<size_t>(Hq) * HD;
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t q_base = (static_cast<size_t>(b) * Sq * Hq + hq) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;

  load_tile<T, HD, LD>(Qs, q + q_base, q_stride, q0, Sq);
  load_tile<T, HD, LD>(dOs, dO + q_base, q_stride, q0, Sq);
  load_rows_stats(lse_s, D_s, lse, Dv, (static_cast<size_t>(b) * Hq + hq) * Sq, q0, Sq);

  float dQ[4][NE];                  // rows ty + 16 a, columns tx + 16 e
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e) dQ[a][e] = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                // the previous tile's readers are done
    load_tile<T, HD, LD>(Ks, k + kv_base, kv_stride, k0, Sk);
    load_tile<T, HD, LD>(Vs, v + kv_base, kv_stride, k0, Sk);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, Sq, Sk, causal, sl2, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dSs[(ty + 16 * a) * LDP + tx + 16 * c] = ds[a][c];
    __syncthreads();

    // dQ[i] += dS[i, j] K[j] over the tile's keys, four at a time
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float dj[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 d4 = *reinterpret_cast<const float4*>(dSs + (ty + 16 * a) * LDP + j);
        dj[a][0] = d4.x;
        dj[a][1] = d4.y;
        dj[a][2] = d4.z;
        dj[a][3] = d4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float kv = Ks[(j + jj) * LD + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < 4; ++a) dQ[a][e] += dj[a][jj] * kv;
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qpos = q0 + ty + 16 * a;
    if (qpos < Sq) {
      T* dqr = dq + q_base + static_cast<size_t>(qpos) * q_stride;
#pragma unroll
      for (int e = 0; e < NE; ++e) dqr[tx + 16 * e] = from_f<T>(dQ[a][e] * scale);
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * Tiles<HD>::T + 2 * BQ * LDP + 2 * BQ);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * Tiles<HD>::T + BQ * LDP + 2 * BQ);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
           const float* lse, float* Dv, void* dq, void* dk, void* dv, int B, int Sq,
           int Sk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dO);
  const size_t rows = static_cast<size_t>(B) * Sq * Hq;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), gp, Dv, B, Sq, Hq, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kv_kernel = flash_bwd_dkdv_kernel<T, HD>;
  constexpr size_t kv_smem = dkdv_smem<HD>();
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<<<dim3((Sk + BK - 1) / BK, Hkv, B), THREADS, kv_smem, stream>>>(
      qp, kp, vp, gp, lse, Dv, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, Hq, Hkv,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto q_kernel = flash_bwd_dq_kernel<T, HD>;
  constexpr size_t q_smem = dq_smem<HD>();
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kernel<<<dim3((Sq + BQ - 1) / BQ, Hq, B), THREADS, q_smem, stream>>>(
      qp, kp, vp, gp, lse, Dv, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_h(const void* q, const void* k, const void* v, const void* o, const void* dO,
             const float* lse, float* Dv, void* dq, void* dk, void* dv, int B, int Sq,
             int Sk, int Hq, int Hkv, int h, int causal, float scale, cudaStream_t s) {
#define RT_ARGS q, k, v, o, dO, lse, Dv, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, scale, s
  switch (h) {
    case 16: return launch<T, 16>(RT_ARGS);
    case 32: return launch<T, 32>(RT_ARGS);
    case 64: return launch<T, 64>(RT_ARGS);
    case 112: return launch<T, 112>(RT_ARGS);
    case 128: return launch<T, 128>(RT_ARGS);
  }
#undef RT_ARGS
  return RT_UNSUPPORTED;
}

}  // namespace

// q, o, dO, dq: (B, Sq, Hq, h); k, v, dk, dv: (B, Sk, Hkv, h); all contiguous,
// one dtype.  lse: (B, Hq, Sq) fp32 from the forward (rt_flash_attention);
// Dv: (B, Hq, Sq) fp32 scratch.  Returns a cudaError_t, or RT_UNSUPPORTED for
// shapes the kernels do not take (as rt_flash_attention).
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dO, const float* lse,
                                      float* Dv, void* dq, void* dk, void* dv, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int h, int causal, float scale,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535)
    return RT_UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_ARGS q, k, v, o, dO, lse, Dv, dq, dk, dv, B, Sq, Sk, Hq, Hkv, h, causal, scale, s
  switch (dtype) {
    case RT_F32: return launch_h<float>(RT_ARGS);
    case RT_BF16: return launch_h<__nv_bfloat16>(RT_ARGS);
    case RT_F16: return launch_h<__half>(RT_ARGS);
  }
#undef RT_ARGS
  return RT_UNSUPPORTED;
}
