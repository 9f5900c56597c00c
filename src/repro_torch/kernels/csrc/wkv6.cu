// RWKV6 WKV recurrence (data-dependent per-channel decay), forward.
//
// Port of repro/kernels/wkv6.py::wkv6_pallas (_wkv6_kernel).  Per (batch,
// head) and chunk of Q = 32 rows, with w the log decay (<= 0), cw its
// exclusive and ci its inclusive cumsum over the chunk and cw_end the sum:
//   A[t][s] = sum_k r_t k_s e^{cw_t - ci_s}  (s < t),   A[t][t] = sum_k r_t u k_t
//   y_t     = (r_t * e^{cw_t}) . S0  +  sum_{s <= t} A[t][s] v_s
//   S_end   = diag(e^{cw_end}) S0  +  sum_s (k_s * e^{cw_end - ci_s}) v_s^T
// The TPU kernel walks the chunks as a sequential grid axis with the (K, V)
// state in VMEM scratch, and forms the (Q, Q, K) decay tensor in VMEM.
// Blocks on Hopper run in no order, so here one block owns one (batch, head)
// and loops over its chunks itself:
//   * the (K, V) fp32 state stays in shared memory for the whole sequence
//     (16 KB at K = V = 64); each chunk's r, k, v and the two cumsums of w
//     are staged in shared memory as fp32;
//   * the (Q, Q, K) decay tensor is never formed: it would be 256 KB at
//     K = 64, over the 227 KB a block can have.  Each A[t][s] loops over k
//     and takes its exponential on the fly; a warp owns one row t, its lanes
//     the columns s, and the k-major tiles are padded so that those lanes
//     read distinct banks;
//   * the exponent is taken only where s < t (a select, not a multiply):
//     above the diagonal it is positive and e^x may be inf, and inf * 0 is
//     NaN;
//   * S need not be a chunk multiple.  Rows past S are zero in shared memory
//     (log decay 0, i.e. decay 1, and k = 0, so the state is unchanged, as
//     the reference's zero padding leaves it), and the loops stop at the
//     chunk's last row, so decode's S = 1 costs one row, not 32.
//
// Bound on the H100: at rwkv6-1.6b prefill (B = 8, S = 512, H = 32,
// K = V = 64) the kernel moves about 172 MB (r, k, v, w, y of 34 MB each)
// for about 3 GFLOP, some 17 flops a byte, under the card's ~20 fp32 flops
// per byte: bytes, at 3.35 TB/s.  One block per (batch, head) gives only 256
// blocks there, under two per SM; splitting a head's value columns over
// blocks is for a later version.
#include "common.cuh"

namespace {

constexpr int Q = 32;              // rows per chunk
constexpr int THREADS = 256;

template <int K, int V>
struct Layout {                    // shared memory, in floats
  static constexpr int LDK = K + 1;      // lanes walk down s: padded
  static constexpr int R = 0;            // r, then r * e^{cw}
  static constexpr int KK = R + Q * LDK; // k, then k * e^{cw_end - ci}
  static constexpr int CW = KK + Q * LDK;
  static constexpr int CI = CW + Q * LDK;
  static constexpr int VV = CI + Q * LDK;
  static constexpr int A = VV + Q * V;
  static constexpr int ST = A + Q * (Q + 1);
  static constexpr int U = ST + K * V;
  static constexpr int END = U + K;
  static constexpr int TOTAL = END + K;
  static constexpr size_t bytes = sizeof(float) * TOTAL;
};

template <typename T, int K, int V>
__global__ void __launch_bounds__(THREADS)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ sf, int S, int H) {
  constexpr int RG = THREADS / V;        // row groups over a V-wide tile
  static_assert(THREADS % V == 0 && Q % RG == 0 && K % RG == 0, "bad K, V");
  using Lay = Layout<K, V>;
  constexpr int LDK = Lay::LDK;
  extern __shared__ float smem[];
  float* Rs = smem + Lay::R;
  float* Ks = smem + Lay::KK;
  float* CWs = smem + Lay::CW;
  float* CIs = smem + Lay::CI;
  float* Vs = smem + Lay::VV;
  float* As = smem + Lay::A;
  float* Ss = smem + Lay::ST;
  float* Us = smem + Lay::U;
  float* ends = smem + Lay::END;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row_k = static_cast<size_t>(H) * K;     // between positions
  const size_t row_v = static_cast<size_t>(H) * V;
  const size_t off_k = static_cast<size_t>(b) * S * row_k + static_cast<size_t>(h) * K;
  const size_t off_v = static_cast<size_t>(b) * S * row_v + static_cast<size_t>(h) * V;

  for (int e = tid; e < K * V; e += THREADS) Ss[e] = s0 ? s0[bh * K * V + e] : 0.f;
  for (int c = tid; c < K; c += THREADS) Us[c] = u[static_cast<size_t>(h) * K + c];

  const int vc = tid % V, rg = tid / V;  // this thread's column and row group
  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qn = min(Q, S - c0);       // rows of this chunk
    __syncthreads();                     // the previous chunk is consumed
    for (int e = tid; e < Q * K; e += THREADS) {
      const int t = e / K, c = e % K;
      const bool in = t < qn;
      const size_t g = off_k + (c0 + t) * row_k + c;
      Rs[t * LDK + c] = in ? to_f(r[g]) : 0.f;
      Ks[t * LDK + c] = in ? to_f(k[g]) : 0.f;
      CIs[t * LDK + c] = in ? w[g] : 0.f;
    }
    for (int e = tid; e < Q * V; e += THREADS) {
      const int t = e / V, c = e % V;
      Vs[t * V + c] = t < qn ? to_f(v[off_v + (c0 + t) * row_v + c]) : 0.f;
    }
    __syncthreads();

    for (int c = tid; c < K; c += THREADS) {   // cumsums of w, per channel
      float run = 0.f;
      for (int t = 0; t < qn; ++t) {
        CWs[t * LDK + c] = run;
        run += CIs[t * LDK + c];
        CIs[t * LDK + c] = run;
      }
      ends[c] = run;
    }
    __syncthreads();

    // A[t][s]: a warp per row t, a lane per column s
    for (int t = warp; t < Q; t += THREADS / 32) {
      const int s = lane;
      float acc = 0.f;
      if (t < qn && s < t) {
        for (int c = 0; c < K; ++c)
          acc += Rs[t * LDK + c] * Ks[s * LDK + c] * expf(CWs[t * LDK + c] - CIs[s * LDK + c]);
      } else if (t < qn && s == t) {
        for (int c = 0; c < K; ++c) acc += Rs[t * LDK + c] * Us[c] * Ks[t * LDK + c];
      }
      As[t * (Q + 1) + s] = acc;
    }
    __syncthreads();

    for (int e = tid; e < qn * K; e += THREADS) {   // fold the decays into r, k
      const int t = e / K, c = e % K;
      Rs[t * LDK + c] *= expf(CWs[t * LDK + c]);
      Ks[t * LDK + c] *= expf(ends[c] - CIs[t * LDK + c]);
    }
    __syncthreads();

    // y[t][vc] = (r_t e^{cw_t}) . S0[:, vc] + sum_s A[t][s] v[s][vc]
    {
      float acc[Q / RG] = {};
      for (int c = 0; c < K; ++c) {
        const float sv = Ss[c * V + vc];
#pragma unroll
        for (int i = 0; i < Q / RG; ++i) acc[i] += Rs[(rg + RG * i) * LDK + c] * sv;
      }
      for (int s = 0; s < qn; ++s) {
        const float vv = Vs[s * V + vc];
#pragma unroll
        for (int i = 0; i < Q / RG; ++i) acc[i] += As[(rg + RG * i) * (Q + 1) + s] * vv;
      }
#pragma unroll
      for (int i = 0; i < Q / RG; ++i) {
        const int t = rg + RG * i;
        if (t < qn) y[off_v + (c0 + t) * row_v + vc] = from_f<T>(acc[i]);
      }
    }
    __syncthreads();                     // every read of S0 is done

    // S[c][vc] = e^{cw_end[c]} S[c][vc] + sum_s k~[s][c] v[s][vc]
    {
      float acc[K / RG] = {};
      for (int s = 0; s < qn; ++s) {
        const float vv = Vs[s * V + vc];
#pragma unroll
        for (int j = 0; j < K / RG; ++j) acc[j] += Ks[s * LDK + rg + RG * j] * vv;
      }
#pragma unroll
      for (int j = 0; j < K / RG; ++j) {
        const int c = rg + RG * j;
        Ss[c * V + vc] = expf(ends[c]) * Ss[c * V + vc] + acc[j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < K * V; e += THREADS) sf[bh * K * V + e] = Ss[e];
}

template <typename T, int K, int V>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, void* y, float* sf, int B, int S, int H, cudaStream_t stream) {
  auto kernel = wkv6_fwd_kernel<T, K, V>;
  constexpr size_t smem = Layout<K, V>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      s0, static_cast<T*>(y), sf, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_v(const void* r, const void* k, const void* v, const float* w, const float* u,
             const float* s0, void* y, float* sf, int B, int S, int H, int V,
             cudaStream_t s) {
  switch (V) {
    case 16: return launch<T, K, 16>(r, k, v, w, u, s0, y, sf, B, S, H, s);
    case 32: return launch<T, K, 32>(r, k, v, w, u, s0, y, sf, B, S, H, s);
    case 64: return launch<T, K, 64>(r, k, v, w, u, s0, y, sf, B, S, H, s);
    case 128: return launch<T, K, 128>(r, k, v, w, u, s0, y, sf, B, S, H, s);
  }
  return RT_UNSUPPORTED;
}

template <typename T>
int launch_kv(const void* r, const void* k, const void* v, const float* w, const float* u,
              const float* s0, void* y, float* sf, int B, int S, int H, int K, int V,
              cudaStream_t s) {
  switch (K) {
    case 16: return launch_v<T, 16>(r, k, v, w, u, s0, y, sf, B, S, H, V, s);
    case 32: return launch_v<T, 32>(r, k, v, w, u, s0, y, sf, B, S, H, V, s);
    case 64: return launch_v<T, 64>(r, k, v, w, u, s0, y, sf, B, S, H, V, s);
    case 128: return launch_v<T, 128>(r, k, v, w, u, s0, y, sf, B, S, H, V, s);
  }
  return RT_UNSUPPORTED;
}

}  // namespace

// r, k: (B, S, H, K), v, y: (B, S, H, V), contiguous, dtype `dtype` (fp32 or
// bf16); w: (B, S, H, K), u: (H, K), s0 (may be null: zeros) and sf:
// (B, H, K, V), all fp32 and contiguous.  Returns a cudaError_t, or
// RT_UNSUPPORTED for what the kernel does not take (K or V outside
// {16, 32, 64, 128}, another dtype, a grid dimension over its limit).
extern "C" int rt_wkv6(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* s0, void* y, void* sf, int B, int S,
                       int H, int K, int V, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535) return RT_UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sff = static_cast<float*>(sf);
  switch (dtype) {
    case RT_F32: return launch_kv<float>(r, k, v, wf, uf, s0f, y, sff, B, S, H, K, V, s);
    case RT_BF16: return launch_kv<__nv_bfloat16>(r, k, v, wf, uf, s0f, y, sff, B, S, H, K, V, s);
  }
  return RT_UNSUPPORTED;
}
