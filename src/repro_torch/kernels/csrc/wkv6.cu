// RWKV6 WKV recurrence (data-dependent per-channel decay), forward: the
// chunked kernel that kernels/wkv6.py runs for S > 1 (wkv6_step.cu takes
// S == 1).
//
// Replaces repro/kernels/wkv6.py::wkv6_pallas (_wkv6_kernel, the
// pl.pallas_call at wkv6.py:66).  Per (batch, head) with the (K, V) state S:
//   S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T,   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
// The TPU kernel walks chunks as a sequential grid axis with the state in
// VMEM scratch and forms the (Q, Q, K) decay tensor of each chunk in VMEM.
// Blocks on Hopper run in no order, so one block of 8 warps owns one
// (batch, head) and loops over its chunks of Q = 32 rows with the fp32 state
// in shared memory.
//
// Precondition: w <= 0 (a decay of at most 1; the model's log decay is
// -exp(.)).  Then every exponential below is of a number <= 0.
//
// The algorithm (ref.wkv6_subchunked_ref is the same in plain PyTorch).
// Every decay is in base 2, w2 = w log2(e), scaled once on arrival.  A chunk
// is cut into sub-chunks of L = SUB = 8 rows (the kernel is templated on L;
// L = 16 measured 3-7 % slower on the H100).  Per channel:
//   d_t      = 2^{w2_t}, the decay of row t;
//   q_t      = r_t 2^{sum of w2 over the rows of t's sub-chunk before t};
//   kk_s     = k_s 2^{sum of w2 over the rows of s's sub-chunk after s};
//   P[a][m]  = 2^{sum of w2 over sub-chunks m .. a-1}  (m < a; P[a][a] = 1).
// All four are <= 1.  For t in sub-chunk i and s in sub-chunk j:
//   A[t][s] = sum_c q_t P[i][j+1] kk_s                     (j < i: a product)
//   A[t][s] = sum_c r_t k_s prod_{s < tau < t} d_tau       (j = i, s < t)
//   A[t][t] = sum_c r_t u k_t
//   y_t     = (q_t . P[i][0]) S0 + sum_{s <= t} A[t][s] v_s
//   S_end   = diag(P[n][0]) S0 + sum_j diag(P[n][j+1]) sum_{s in j} kk_s v_s^T
// where n = Q / L: the factored form puts the cross-sub-chunk part of A,
// and all of y's and the state's, in products, with no factor above 1, so
// nothing overflows at any decay, and a factor that underflows to 0 stands
// for a true product below 2^-126.  Every exponent is the sum over the rows
// it spans, never the difference of two running sums: after a step of
// strong decay (w of -1000) such a difference keeps only its rounding, about
// 1e-4 in the exponent, which is 1e-4 of relative error in a decay of order
// 1.  Inside a sub-chunk the decays multiply up step by step, as the
// recurrence does, so no exponential is taken there at all.
//
// Bound on the H100: at rwkv6-1.6b prefill (B = 8, S = 512, H = 32,
// K = V = 64) the kernel moves about 172 MB (r, k, v, w, y of 34 MB each):
// 0.0513 ms at 3.35 TB/s.  Its products are about 330 k FMAs a chunk,
// 1.35 G in all, 0.040 ms at the CUDA cores' 67 TFLOP/s: the two bounds are
// of one order, so the design keeps both the copies and the FMAs busy:
//   * the next chunk's r, k, w (Q x K) and v (Q x V) fly in by 16-byte
//     cp.async into a second buffer while this chunk computes (one buffer
//     where two do not fit: K = V = 128); rows past S are zero-filled, so
//     k = 0 and w = 0 there and they change neither y nor the state;
//   * a chunk has three barriers, between three phases:
//     1. per channel, lane t of a warp holds row t: w2, d, the sub-chunk
//        scans (shuffles of width L, forward and backward) and the sub-chunk
//        sums give q, kk and P, written once; d overwrites w in place;
//     2. y's state part (q . P[i][0]) S0 on all warps, 2 rows x 4 columns a
//        thread (7 16-byte loads for 40 FMAs), and A: warps 0-3 the blocks
//        on the diagonal, where lane (group g, channel group) walks two
//        columns s = g and L - 2 - g down the block with a running product
//        of decays (L steps for every g, and two of the L diagonal terms),
//        warps 4-6 the blocks below it, 4 entries of a row a thread;
//     3. y = that + A v (2 x 4 a thread) and the state update, 4 x 4 a
//        thread, each state element read and written by one thread;
//   * tiles are padded by 16 bytes a row, so that lanes reading one column
//     of consecutive rows hit distinct banks; at <fp32, 64, 64> a block takes
//     110,720 B and two blocks (16 warps) fit an SM;
//   * bf16 inputs are copied raw and converted on read.
#include "common.cuh"

namespace {

constexpr int Q = 32;                  // rows per chunk
constexpr int SUB = 8;                 // rows per sub-chunk (L)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block can have

template <typename T, int K, int V, int L>
struct Layout {
  static constexpr int PAD_T = 16 / static_cast<int>(sizeof(T));
  static constexpr int LDT = K + PAD_T;      // r, k rows (elements of T)
  static constexpr int LDVT = V + PAD_T;     // v rows (elements of T)
  static constexpr int LDW = K + 4;          // fp32 rows over K
  static constexpr int LDA = Q + 1;
  static constexpr int NS = Q / L;           // sub-chunks
  static constexpr int NP = NS * (NS + 1) / 2;   // P[a][m], m < a; row NP is ones
  // one stage: r, k (T), w then d (fp32), v (T), in bytes
  static constexpr int R = 0;
  static constexpr int KK = R + Q * LDT * static_cast<int>(sizeof(T));
  static constexpr int W = KK + Q * LDT * static_cast<int>(sizeof(T));
  static constexpr int VV = W + Q * LDW * 4;
  static constexpr int STAGE = VV + Q * LDVT * static_cast<int>(sizeof(T));
  // shared by the stages, fp32
  static constexpr int REST = 4 * (2 * Q * LDW + (NP + 1) * K + Q * LDA + K * V + K);
  static constexpr int STAGES = 2 * STAGE + REST <= SMEM_LIMIT ? 2 : 1;
  static constexpr int QS = STAGES * STAGE;
  static constexpr int KS = QS + 4 * Q * LDW;
  static constexpr int PT = KS + 4 * Q * LDW;
  static constexpr int AS = PT + 4 * (NP + 1) * K;
  static constexpr int SS = AS + 4 * Q * LDA;
  static constexpr int US = SS + 4 * K * V;
  static constexpr int bytes = US + 4 * K;
  static_assert(STAGE % 16 == 0 && QS % 16 == 0 && PT % 16 == 0 && SS % 16 == 0,
                "16-byte aligned tiles");
  static_assert(bytes <= SMEM_LIMIT, "shared memory");
};

// P[a][m] (m < a) is row a(a-1)/2 + m of the table
__host__ __device__ constexpr int pidx(int a, int m) { return a * (a - 1) / 2 + m; }

__device__ __forceinline__ float4 ld4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4f(float* p, float4 a) {
  *reinterpret_cast<float4*>(p) = a;
}
// four consecutive elements of shared memory as fp32
__device__ __forceinline__ float4 ld4(const float* p) { return ld4f(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float4 exp2_4(float4 a) {
  return make_float4(exp2f(a.x), exp2f(a.y), exp2f(a.z), exp2f(a.w));
}
__device__ __forceinline__ float get(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}
// acc += s * b, four lanes
__device__ __forceinline__ void fma4(float4& acc, float s, float4 b) {
  acc.x += s * b.x; acc.y += s * b.y; acc.z += s * b.z; acc.w += s * b.w;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 a) {
  if constexpr (std::is_same_v<T, float>) {
    st4f(p, a);
  } else {
    p[0] = from_f<T>(a.x); p[1] = from_f<T>(a.y);
    p[2] = from_f<T>(a.z); p[3] = from_f<T>(a.w);
  }
}

// inclusive scan of x over the L lanes of a lane's segment, forward
// (lane t sums t0 .. t) or backward (t .. t0 + L - 1)
template <int L, bool kForward>
__device__ __forceinline__ float seg_scan(float x, int pos) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    const float n = kForward ? __shfl_up_sync(kFull, x, o, L) : __shfl_down_sync(kFull, x, o, L);
    if (kForward ? pos >= o : pos + o < L) x += n;
  }
  return x;
}

// the next chunk's rows, 16 bytes a copy, zero past S
template <typename T, int K, int V, int L>
__device__ __forceinline__ void issue_chunk(unsigned char* stage, const T* r, const T* k,
                                            const float* w, const T* v, size_t off_k,
                                            size_t off_v, size_t row_k, size_t row_v,
                                            int c0, int S, int tid) {
  using Lay = Layout<T, K, V, L>;
  constexpr int PK = K * static_cast<int>(sizeof(T)) / 16;   // copies a row of r or k
  constexpr int PW = K / 4;
  constexpr int PV = V * static_cast<int>(sizeof(T)) / 16;
  T* Rs = reinterpret_cast<T*>(stage + Lay::R);
  T* Ks = reinterpret_cast<T*>(stage + Lay::KK);
  float* Ws = reinterpret_cast<float*>(stage + Lay::W);
  T* Vs = reinterpret_cast<T*>(stage + Lay::VV);
  constexpr int ET = 16 / static_cast<int>(sizeof(T));        // elements a copy
  for (int e = tid; e < Q * PK; e += THREADS) {
    const int t = e / PK, p = e % PK;
    const bool in = c0 + t < S;
    const size_t g = off_k + static_cast<size_t>(in ? c0 + t : c0) * row_k + p * ET;
    cp_async16(reinterpret_cast<float*>(Rs + t * Lay::LDT + p * ET), r + g, in);
    cp_async16(reinterpret_cast<float*>(Ks + t * Lay::LDT + p * ET), k + g, in);
  }
  for (int e = tid; e < Q * PW; e += THREADS) {
    const int t = e / PW, p = e % PW;
    const bool in = c0 + t < S;
    cp_async16(Ws + t * Lay::LDW + 4 * p,
               w + off_k + static_cast<size_t>(in ? c0 + t : c0) * row_k + 4 * p, in);
  }
  for (int e = tid; e < Q * PV; e += THREADS) {
    const int t = e / PV, p = e % PV;
    const bool in = c0 + t < S;
    cp_async16(reinterpret_cast<float*>(Vs + t * Lay::LDVT + p * ET),
               v + off_v + static_cast<size_t>(in ? c0 + t : c0) * row_v + p * ET, in);
  }
}

template <typename T, int K, int V, int L>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s0,
                T* __restrict__ y, float* sf, int S, int H) {
  using Lay = Layout<T, K, V, L>;
  constexpr int NS = Lay::NS, NP = Lay::NP, ONES = NP;
  constexpr int LDT = Lay::LDT, LDVT = Lay::LDVT, LDW = Lay::LDW, LDA = Lay::LDA;
  constexpr int KQ = K / 4, VQ = V / 4;           // 4-float quads of a row
  constexpr int YTILES = (Q / 2) * VQ;            // 2 rows x 4 columns
  constexpr int STILES = KQ * VQ;                 // 4 rows x 4 columns
  static_assert(Q % L == 0 && L % 4 == 0 && L <= 32 && KQ >= 1 && VQ >= 1, "bad L, K, V");
  extern __shared__ __align__(16) unsigned char smem[];
  float* QS = reinterpret_cast<float*>(smem + Lay::QS);
  float* KS = reinterpret_cast<float*>(smem + Lay::KS);
  float* PT = reinterpret_cast<float*>(smem + Lay::PT);
  float* AS = reinterpret_cast<float*>(smem + Lay::AS);
  float* SS = reinterpret_cast<float*>(smem + Lay::SS);
  float* US = reinterpret_cast<float*>(smem + Lay::US);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t row_k = static_cast<size_t>(H) * K;     // between positions
  const size_t row_v = static_cast<size_t>(H) * V;
  const size_t off_k = static_cast<size_t>(b) * S * row_k + static_cast<size_t>(h) * K;
  const size_t off_v = static_cast<size_t>(b) * S * row_v + static_cast<size_t>(h) * V;

  issue_chunk<T, K, V, L>(smem, r, k, w, v, off_k, off_v, row_k, row_v, 0, S, tid);
  cp_async_commit();
  for (int e = tid; e < K * VQ; e += THREADS) {
    st4f(SS + 4 * e, s0 ? ld4f(s0 + bh * K * V + 4 * e) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  for (int c = tid; c < K; c += THREADS) {
    US[c] = u[static_cast<size_t>(h) * K + c];
    PT[ONES * K + c] = 1.f;
  }

  // this thread's y tiles: rows 2 tp, 2 tp + 1 and columns 4 vq .. 4 vq + 3
  constexpr int YT = (YTILES + THREADS - 1) / THREADS;
  float4 yacc[YT][2];

  const int nchunks = (S + Q - 1) / Q;
  for (int n = 0; n < nchunks; ++n) {
    const int c0 = n * Q;
    unsigned char* stage = smem + (Lay::STAGES == 2 ? (n & 1) * Lay::STAGE : 0);
    if constexpr (Lay::STAGES == 2) {
      cp_async_wait<0>();
      __syncthreads();                 // this chunk landed; the other buffer is free
      if (n + 1 < nchunks) {
        issue_chunk<T, K, V, L>(smem + ((n + 1) & 1) * Lay::STAGE, r, k, w, v, off_k, off_v,
                                row_k, row_v, c0 + Q, S, tid);
      }
      cp_async_commit();
    } else {
      if (n > 0) {
        __syncthreads();               // the buffer is consumed
        issue_chunk<T, K, V, L>(smem, r, k, w, v, off_k, off_v, row_k, row_v, c0, S, tid);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
    }
    const T* Rs = reinterpret_cast<const T*>(stage + Lay::R);
    const T* Kst = reinterpret_cast<const T*>(stage + Lay::KK);
    float* Ds = reinterpret_cast<float*>(stage + Lay::W);
    const T* Vs = reinterpret_cast<const T*>(stage + Lay::VV);

    // ---- phase 1: lane t holds row t; a warp takes 4 channels at a time
    {
      const int t = lane, pos = t % L;
      for (int qd = warp; qd < KQ; qd += WARPS) {
        const int c = 4 * qd;
        const float4 wv = ld4f(Ds + t * LDW + c);
        const float w2[4] = {wv.x * kLog2e, wv.y * kLog2e, wv.z * kLog2e, wv.w * kLog2e};
        float before[4], after[4], tot[4][NS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float inc = seg_scan<L, true>(w2[i], pos);
          const float ex = __shfl_up_sync(kFull, inc, 1, L);
          before[i] = pos == 0 ? 0.f : ex;
          const float sinc = seg_scan<L, false>(w2[i], pos);
          const float sx = __shfl_down_sync(kFull, sinc, 1, L);
          after[i] = pos == L - 1 ? 0.f : sx;
#pragma unroll
          for (int x = 0; x < NS; ++x) tot[i][x] = __shfl_sync(kFull, inc, x * L + L - 1);
        }
        st4f(Ds + t * LDW + c, exp2_4(make_float4(w2[0], w2[1], w2[2], w2[3])));
        const float4 rt = ld4(Rs + t * LDT + c), kt = ld4(Kst + t * LDT + c);
        st4f(QS + t * LDW + c,
             mul4(rt, exp2_4(make_float4(before[0], before[1], before[2], before[3]))));
        st4f(KS + t * LDW + c,
             mul4(kt, exp2_4(make_float4(after[0], after[1], after[2], after[3]))));
        if (t < NP) {                  // lane t: P[a][m] of row t of the table
          int a = 1;
          while (pidx(a + 1, 0) <= t) ++a;
          const int m = t - pidx(a, 0);
          float e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float sum = 0.f;
#pragma unroll
            for (int x = 0; x < NS; ++x) sum += (x >= m && x < a) ? tot[i][x] : 0.f;
            e[i] = exp2f(sum);
          }
          st4f(PT + t * K + c, make_float4(e[0], e[1], e[2], e[3]));
        }
      }
    }
    __syncthreads();

    // ---- phase 2: y's state part on every thread; then A
#pragma unroll
    for (int m = 0; m < YT; ++m) {
      const int tile = tid + THREADS * m;
      yacc[m][0] = yacc[m][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tile < YTILES) {
        const int t0 = 2 * (tile / VQ), vq = tile % VQ;
        const int i = t0 / L;
        const float* E = PT + (i == 0 ? ONES : pidx(i, 0)) * K;
        for (int qd = 0; qd < KQ; ++qd) {
          const int c = 4 * qd;
          const float4 e = ld4f(E + c);
          const float4 a0 = mul4(ld4f(QS + t0 * LDW + c), e);
          const float4 a1 = mul4(ld4f(QS + (t0 + 1) * LDW + c), e);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 s = ld4f(SS + (c + cc) * V + 4 * vq);
            fma4(yacc[m][0], get(a0, cc), s);
            fma4(yacc[m][1], get(a1, cc), s);
          }
        }
      }
    }
    if (tid < 128) {
      // the blocks on the diagonal: 16 groups of 8 lanes; group (x, g) walks
      // columns g and L - 2 - g of sub-chunk x and two diagonal terms, each
      // lane over channel quads cg, cg + 8, ...
      const int cg = tid % 8, grp = tid / 8;
      const int x = grp / (L / 2), g = grp % (L / 2);
      const int xs = x * L, n1 = L - 1 - g;
      const bool second = g != L / 2 - 1;   // the middle group has one column
      float acc[L + 2];
#pragma unroll
      for (int j = 0; j < L + 2; ++j) acc[j] = 0.f;
      for (int qd = cg; qd < KQ; qd += 8) {
        const int c = 4 * qd;
        float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const bool first = j < n1;
          if (first || second) {
            const int s = first ? g : L - 2 - g, t = first ? g + 1 + j : j;
            if (j == 0 || j == n1) f = make_float4(1.f, 1.f, 1.f, 1.f);
            const float4 ks = mul4(ld4(Kst + (xs + s) * LDT + c), f);
            acc[j] += dot4(ld4(Rs + (xs + t) * LDT + c), ks);
            f = mul4(f, ld4f(Ds + (xs + t) * LDW + c));
          }
        }
#pragma unroll
        for (int j = L; j < L + 2; ++j) {
          const int t = 2 * g + j - L;
          const float4 ku = mul4(ld4(Kst + (xs + t) * LDT + c), ld4f(US + c));
          acc[j] += dot4(ld4(Rs + (xs + t) * LDT + c), ku);
        }
      }
#pragma unroll
      for (int j = 0; j < L + 2; ++j) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
      }
#pragma unroll
      for (int j = 0; j < L + 2; ++j) {
        if (j % 8 != cg) continue;
        if (j < L) {
          const bool first = j < n1;
          if (first || second) {
            const int s = first ? g : L - 2 - g, t = first ? g + 1 + j : j;
            AS[(xs + t) * LDA + xs + s] = acc[j];
            AS[(xs + s) * LDA + xs + t] = 0.f;     // above the diagonal
          }
        } else {
          const int t = 2 * g + j - L;
          AS[(xs + t) * LDA + xs + t] = acc[j];
        }
      }
    } else {
      // the blocks below the diagonal: a thread takes 4 entries of one row t
      // of sub-chunk i >= 1 (4 columns s of one sub-chunk j < i); lanes take
      // consecutive rows
      int unit = tid - 128, i = 1;
      for (; i < NS; ++i) {
        const int cnt = L * (i * L / 4);
        if (unit < cnt) break;
        unit -= cnt;
      }
      if (i < NS) {
        const int t = i * L + unit % L, s0 = 4 * (unit / L), j = s0 / L;
        const float* Pij = PT + (j + 1 == i ? ONES : pidx(i, j + 1)) * K;
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
        for (int qd = 0; qd < KQ; ++qd) {
          const int c = 4 * qd;
          const float4 qp = mul4(ld4f(QS + t * LDW + c), ld4f(Pij + c));
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) a4[mm] += dot4(qp, ld4f(KS + (s0 + mm) * LDW + c));
        }
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) AS[t * LDA + s0 + mm] = a4[mm];
      }
    }
    __syncthreads();

    // ---- phase 3: y = its state part + A v; the state update
    const int qn = min(Q, S - c0);
#pragma unroll
    for (int m = 0; m < YT; ++m) {
      const int tile = tid + THREADS * m;
      if (tile < YTILES) {
        const int t0 = 2 * (tile / VQ), vq = tile % VQ;
        for (int s = 0; s <= t0 + 1; ++s) {
          const float4 vs = ld4(Vs + s * LDVT + 4 * vq);
          fma4(yacc[m][0], AS[t0 * LDA + s], vs);
          fma4(yacc[m][1], AS[(t0 + 1) * LDA + s], vs);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (t0 + rr < qn) store4(y + off_v + static_cast<size_t>(c0 + t0 + rr) * row_v + 4 * vq,
                                   yacc[m][rr]);
        }
      }
    }
    const float* G = PT + pidx(NS, 0) * K;
    const bool last = n + 1 == nchunks;
    for (int tile = tid; tile < STILES; tile += THREADS) {
      const int cq = tile / VQ, vq = tile % VQ;
      float4 acc[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float4 part[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) part[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int s = j * L; s < (j + 1) * L; ++s) {
          const float4 kq = ld4f(KS + s * LDW + 4 * cq);
          const float4 vs = ld4(Vs + s * LDVT + 4 * vq);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) fma4(part[cc], get(kq, cc), vs);
        }
        const float4 sc = ld4f(PT + (j + 1 == NS ? ONES : pidx(NS, j + 1)) * K + 4 * cq);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) fma4(acc[cc], get(sc, cc), part[cc]);
      }
      const float4 dec = ld4f(G + 4 * cq);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float* p = SS + (4 * cq + cc) * V + 4 * vq;
        float4 s = ld4f(p);
        const float d = get(dec, cc);
        s = make_float4(d * s.x + acc[cc].x, d * s.y + acc[cc].y, d * s.z + acc[cc].z,
                        d * s.w + acc[cc].w);
        if (last) {
          st4f(sf + bh * K * V + static_cast<size_t>(4 * cq + cc) * V + 4 * vq, s);
        } else {
          st4f(p, s);
        }
      }
    }
  }
}

template <typename T, int K, int V, int L>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, void* y, float* sf, int B, int S, int H, cudaStream_t stream) {
  auto kernel = wkv6_fwd_kernel<T, K, V, L>;
  constexpr int smem = Layout<T, K, V, L>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      s0, static_cast<T*>(y), sf, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_v(const void* r, const void* k, const void* v, const float* w, const float* u,
             const float* s0, void* y, float* sf, int B, int S, int H, int V, cudaStream_t s) {
  switch (V) {
    case 16: return launch<T, K, 16, SUB>(r, k, v, w, u, s0, y, sf, B, S, H, s);
    case 32: return launch<T, K, 32, SUB>(r, k, v, w, u, s0, y, sf, B, S, H, s);
    case 64: return launch<T, K, 64, SUB>(r, k, v, w, u, s0, y, sf, B, S, H, s);
    case 128: return launch<T, K, 128, SUB>(r, k, v, w, u, s0, y, sf, B, S, H, s);
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

template <int K>
int smem_v(int V) {
  switch (V) {
    case 16: return Layout<float, K, 16, SUB>::bytes;
    case 32: return Layout<float, K, 32, SUB>::bytes;
    case 64: return Layout<float, K, 64, SUB>::bytes;
    case 128: return Layout<float, K, 128, SUB>::bytes;
  }
  return RT_UNSUPPORTED;
}

}  // namespace

// The dynamic shared memory of a block of the fp32 chunked kernel at (K, V),
// in bytes, or RT_UNSUPPORTED: what the build reports beside ptxas's counts.
extern "C" int rt_wkv6_smem_bytes(int K, int V) {
  switch (K) {
    case 16: return smem_v<16>(V);
    case 32: return smem_v<32>(V);
    case 64: return smem_v<64>(V);
    case 128: return smem_v<128>(V);
  }
  return RT_UNSUPPORTED;
}

// r, k: (B, S, H, K), v, y: (B, S, H, V), contiguous, dtype `dtype` (fp32 or
// bf16); w: (B, S, H, K) <= 0, u: (H, K), s0 (may be null: zeros) and sf:
// (B, H, K, V), all fp32 and contiguous; r, k, v, w, s0 and sf 16-byte
// aligned; sf may be s0.  Returns a cudaError_t, or RT_UNSUPPORTED for what
// the kernel does not take (K or V outside {16, 32, 64, 128}, another dtype,
// a grid dimension over its limit).
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
    case RT_F32:
      return launch_kv<float>(r, k, v, wf, uf, s0f, y, sff, B, S, H, K, V, s);
    case RT_BF16:
      return launch_kv<__nv_bfloat16>(r, k, v, wf, uf, s0f, y, sff, B, S, H, K, V, s);
  }
  return RT_UNSUPPORTED;
}
