// Forward flash attention, causal or full, with grouped KV heads (GQA), an
// optional sliding window and optional ALiBi biases, on the tensor cores
// with fp32-exact products.
//
// Replaces repro/kernels/flash.py::flash_attention (_flash_kernel, the
// pl.pallas_call at flash.py:79).  The TPU kernel walks a sequential KV grid
// axis with the running max, denominator and fp32 accumulator in VMEM
// scratch.  Here one block owns one (batch, query head, 128-row query tile)
// and walks the KV tiles in a loop; each of its eight warps owns 16 query
// rows, so a row's max, denominator and output accumulator live in that
// warp's registers.
//
// Bound on the H100: operations.  The function does 4·h flops per (query,
// key) pair against 4·h·4 bytes per row of q, k, v and o.  Both products run
// on the TF32 tensor cores (mma.sync m16n8k8) in the 3xTF32 split: each fp32
// operand x = big + small with big = tf32(x) and small = x − big, and a·b is
// big·big + big·small + small·big with fp32 accumulation.  One TF32 product
// misses the reference's 1e-4 bound by about 10x at h = 112 and 128; the
// three-term split is as accurate as fp32 (the dropped small·small term is
// 2^-22 relative).  So the ceiling is 3 × 4·h·pairs TF32 flops at
// 495 TFLOP/s, about 165 TFLOP/s of fp32 work, against 67 on the CUDA cores.
// The kernel is bound by issue slots as much as by the MMAs (each fp32
// operand costs a cvt and a subtraction), so the design saves instructions:
//   * within each 8-wide step of a product, the MMA's k = t and k = t + 4
//     carry columns (or keys) 2t and 2t + 1.  The sum is the same, but a
//     lane's A and B pairs of QKᵀ are then adjacent floats (one 8-byte
//     load each), and P leaves QKᵀ in the C layout exactly where P·V wants
//     its A fragment: P stays in registers, with no shuffle;
//   * small is passed to the MMA as a raw fp32 word, which the TF32 unit
//     reads truncated (a 2^-21 relative error of x), so a split is two
//     instructions;
//   * the MMA's accumulate rounds toward zero, so each KV tile's P·V is
//     summed from zero and added to the running output in fp32
//     (O = O·corr + PV, one fmaf).  With O kept in the MMA across a row's
//     tiles (24 of them over whisper's 1500 frames), a 2-layer whisper
//     training step's gradients erred by 3.8e-5 of their max (layer 0's
//     ln1 bias) and its grad_norm by 1.6e-5 of itself against fp64;
//     summed by tile, by at most 1.1e-5 and 4e-7, at the same time a call;
//   * the row max is reduced over the four lanes that share a row with two
//     shuffles, the denominator only at the end; exponentials are exp2 of
//     scores scaled by log2(e)/sqrt(h); tiles wholly inside the mask skip
//     the mask tests;
//   * K and V tiles (BK = 64 keys) come in with 16-byte cp.async.cg into a
//     double buffer: tile j+1 is in flight while tile j's products run;
//     bf16 and fp16 inputs are converted to fp32 by plain loads instead;
//   * rows are padded (Q, K to h + 8 floats, V to h + 4), so the 8-byte
//     (g, 2t) reads of QKᵀ and the (keys 2t, 2t + 1, column g) reads of P·V
//     hit distinct banks at every supported h, and rows stay 16-byte
//     aligned.  A half-warp's 8-byte reads of rows g = 0..3 start at banks
//     g·(h + 8) mod 32, which is {0, 8, 16, 24} in some order for every h
//     with h + 8 ≡ 8 or 24 mod 32 (h = 16, 32, 64, 80, 112, 128); the P·V
//     reads of rows 2t and 2t + 1 start at 2t·(h + 4) and (2t + 1)·(h + 4)
//     mod 32, again four distinct multiples of 8 plus g = 0..7 when
//     h + 4 ≡ 4, 12, 20 or 28 mod 32, as it is for each of those h;
//   * shared memory is Q + 2 × (K + V): 202 KB at h = 128, 178 KB at
//     h = 112 and 130 KB at h = 80, one block of eight warps per SM; a
//     128-row tile shares each
//     K/V tile among eight warps (64-row tiles with 32-key tiles, two
//     blocks of four warps per SM, were slower on the card);
//   * causal KV tiles past the query tile's last row are never loaded, a
//     warp skips a tile that lies wholly past its own last row, and the
//     longest causal query tiles are launched first;
//   * a sliding window of W keys (key kpos is seen from row qpos when
//     qpos − kpos < W, the reference's mask; 0 = no window) is a run-time
//     argument: KV tiles wholly before the query tile's first window are
//     never loaded, a warp skips a tile wholly before its first row's
//     window, and the causal test and the window's are one unsigned
//     compare, (qpos − kpos) < W with W = INT_MAX for none, so the kernel
//     without a window runs the instructions it ran before.  A row's first
//     tiles may be wholly outside its window (the warp's other rows need
//     them); its masked scores then add garbage at m = −1e30, which the
//     first tile that holds one of its keys scales by exp2(−1e30 − m) = 0;
//   * ALiBi (a per-query-head slope s, the score gaining s·(kpos − qpos))
//     is a template flag, as LSE is: scores are in log2 units, so the
//     bias enters as s·log2(e)·(kpos − qpos), on the inside path too.  The
//     variant with it is built for fp32 only (its one user is the fp32
//     model; bf16 and fp16 would double the build's instantiations), with
//     and without lse (training's backward recomputes P from it);
//   * rows past Sq and keys past Sk are zero-filled by cp.async's source
//     size and masked, so no length has to be a tile multiple;
//   * for training, the launcher may ask for each row's log-sum-exp of its
//     scaled scores (lse, (B, Hq, Sq) fp32, in natural log units), which the
//     backward (flash_bwd.cu) needs to recompute P.  It is a template flag:
//     with a null pointer (serving) the kernel is the one without it (a
//     run-time test in the epilogue cost serving's kernel 2 %).
// The constants are the TPU kernel's: masked scores -1e30, the denominator
// clamped at 1e-20, scores scaled by 1/sqrt(h) after QKᵀ.
#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 128;             // query rows per block
constexpr int BK = 64;              // keys per KV tile
constexpr int WARPS = BQ / 16;      // each owns 16 query rows
constexpr int THREADS = 32 * WARPS;
constexpr float kNegInf = -1e30f;
constexpr float kDenomFloor = 1e-20f;

template <int HD>
struct Layout {                     // in floats; rows padded against bank conflicts
  static constexpr int LDQ = HD + 8;
  static constexpr int LDK = HD + 8;
  static constexpr int LDV = HD + 4;
  static constexpr int Q = BQ * LDQ;
  static constexpr int K = BK * LDK;
  static constexpr int V = BK * LDV;
  static constexpr size_t bytes = sizeof(float) * (Q + 2 * (K + V));
};

// ROWS rows of HD elements, row r at src + (row0 + r) * stride, into dst with
// row pitch LD floats as fp32; rows at or past n are zeros.  fp32 goes by
// 16-byte cp.async (the caller commits); other types by plain loads.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, size_t stride,
                                          int row0, int n) {
  constexpr int CH = HD / 4;        // 4-element chunks per row
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 4;
    const bool in = row0 + r < n;
    const T* p = src + static_cast<size_t>(in ? row0 + r : 0) * stride + c;
    float* d = dst + r * LD + c;
    if constexpr (std::is_same_v<T, float>) {
      cp_async16(d, p, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = in ? to_f(p[i]) : 0.f;
    }
  }
}

template <typename T, int HD, bool LSE, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 const float* __restrict__ slopes, int Sq, int Sk, int Hq, int Hkv,
                 int causal, int win, float scale) {
  static_assert(HD % 8 == 0, "the head dim must be a whole number of 8-wide tiles");
  using L = Layout<HD>;
  constexpr int NH = HD / 8;        // 8-wide tiles of the head dim
  constexpr int NK = BK / 8;        // 8-key tiles of a KV tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // BQ x LDQ
  float* Ks = Qs + L::Q;            // two buffers of BK x LDK
  float* Vs = Ks + 2 * L::K;        // two buffers of BK x LDV

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;        // fragment row and column
  const int row = warp * 16 + g;               // this lane's rows: row, row + 8
  const int qpos[2] = {q0 + row, q0 + row + 8};
  const int warp_first = q0 + warp * 16;       // the warp's query positions
  const int warp_last = warp_first + 15;
  const float scale_log2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)
  float slope_log2 = 0.f;
  if constexpr (ALIBI) slope_log2 = slopes[hq] * 1.4426950408889634f;

  const size_t q_stride = static_cast<size_t>(Hq) * HD;    // between positions
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const T* qb = q + (static_cast<size_t>(b) * Sq * Hq + hq) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  T* ob = o + (static_cast<size_t>(b) * Sq * Hq + hq) * HD;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int ntiles = (k_end + BK - 1) / BK;
  const int j0 = max(0, q0 - win + 1) / BK;     // the first tile in a row's window
  load_rows<T, HD, BQ, L::LDQ>(Qs, qb, q_stride, q0, Sq);
  load_rows<T, HD, BK, L::LDK>(Ks + (j0 & 1) * L::K, kb, kv_stride, j0 * BK, Sk);
  load_rows<T, HD, BK, L::LDV>(Vs + (j0 & 1) * L::V, vb, kv_stride, j0 * BK, Sk);
  cp_async_commit();

  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums

  for (int j = j0; j < ntiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < ntiles) {           // the next tile flies while this one runs
      const int nb = (j + 1) & 1;
      load_rows<T, HD, BK, L::LDK>(Ks + nb * L::K, kb, kv_stride, k0 + BK, Sk);
      load_rows<T, HD, BK, L::LDV>(Vs + nb * L::V, vb, kv_stride, k0 + BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                // tile j (and Q) visible to every warp

    // warp-uniform: the tile holds a key of one of the warp's rows
    if ((!causal || k0 <= warp_last) && k0 + BK - 1 > warp_first - win) {
      const float* Kt = Ks + (j & 1) * L::K;
      const float* Vt = Vs + (j & 1) * L::V;

      // S = Q Kᵀ: 16 rows x BK keys per warp, in the C layout.  Within each
      // 8-wide step of the head dim, the MMA's k = t and k = t + 4 carry
      // columns 2t and 2t + 1, so a lane's A and B pairs are adjacent floats.
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
      const float* qa = Qs + row * L::LDQ + 2 * t;
      const float* ka = Kt + g * L::LDK + 2 * t;
#pragma unroll
      for (int d = 0; d < NH; ++d) {
        const float2 q_lo = *reinterpret_cast<const float2*>(qa + 8 * d);
        const float2 q_hi = *reinterpret_cast<const float2*>(qa + 8 * L::LDQ + 8 * d);
        uint32_t a_big[4], a_small[4];
        split(q_lo.x, a_big[0], a_small[0]);
        split(q_hi.x, a_big[1], a_small[1]);
        split(q_lo.y, a_big[2], a_small[2]);
        split(q_hi.y, a_big[3], a_small[3]);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(ka + 8 * n * L::LDK + 8 * d);
          mma3(s[n], a_big, a_small, kv);
        }
      }

      // scale (into log2 units), bias and mask; the running max over the
      // quad that shares a row.  A tile wholly inside the mask (and every
      // row's window) skips the tests.
      const bool inside = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= warp_first) &&
                          k0 > warp_last - win;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + 8 * n + 2 * t + (i & 1);
          const int d = qpos[i / 2] - kpos;
          const bool ok = inside || (kpos < Sk && (causal ? static_cast<unsigned>(d) <
                                                                static_cast<unsigned>(win)
                                                          : d < win));
          float sc = s[n][i] * scale_log2;
          if constexpr (ALIBI) sc = fmaf(slope_log2, static_cast<float>(-d), sc);
          s[n][i] = ok ? sc : kNegInf;
          mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] = exp2f(s[n][i] - m[i / 2]);
          l[i / 2] += s[n][i];
        }
      // O = O·corr + P V.  In each 8-key step the MMA's k = t and k = t + 4
      // carry keys 2t and 2t + 1, which is where the C layout left this
      // lane's P: P is already an A fragment, with no shuffle.  The tile's
      // P V is summed from zero in the MMA and added to O in fp32 (the
      // MMA's accumulate rounds toward zero: see the head comment).
      float pv[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[n][i] = 0.f;
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        uint32_t a_big[4], a_small[4];
        split(s[c][0], a_big[0], a_small[0]);   // (row, key 2t)
        split(s[c][2], a_big[1], a_small[1]);   // (row + 8, key 2t)
        split(s[c][1], a_big[2], a_small[2]);   // (row, key 2t + 1)
        split(s[c][3], a_big[3], a_small[3]);   // (row + 8, key 2t + 1)
        const float* vr = Vt + (8 * c + 2 * t) * L::LDV + g;
#pragma unroll
        for (int n = 0; n < NH; ++n)
          mma3(pv[n], a_big, a_small, make_float2(vr[8 * n], vr[L::LDV + 8 * n]));
      }
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = fmaf(acc[n][i], corr[i / 2], pv[n][i]);
    }
    __syncthreads();                // tile j consumed before its buffer refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qpos[r] < Sq) {
      const float inv = 1.f / fmaxf(l[r], kDenomFloor);
      T* orow = ob + static_cast<size_t>(qpos[r]) * q_stride + 2 * t;
#pragma unroll
      for (int n = 0; n < NH; ++n)
        store2(orow + 8 * n, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      if (LSE && t == 0)              // m is in log2 units: back to natural log
        lse[(static_cast<size_t>(b) * Hq + hq) * Sq + qpos[r]] =
            (m[r] + log2f(fmaxf(l[r], kDenomFloor))) * 0.6931471805599453f;
    }
  }
}

template <typename T, int HD, bool LSE, bool ALIBI>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        const float* slopes, int B, int Sq, int Sk, int Hq, int Hkv, int causal, int win,
        float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD, LSE, ALIBI>;
  constexpr size_t smem = Layout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, slopes, Sq, Sk, Hq, Hkv, causal, win, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const float* slopes, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
           int win, float scale, cudaStream_t stream) {
#define RT_ARGS q, k, v, o, lse, slopes, B, Sq, Sk, Hq, Hkv, causal, win, scale, stream
  if (slopes != nullptr) {          // ALiBi: fp32 only
    if constexpr (std::is_same_v<T, float>)
      return lse != nullptr ? run<T, HD, true, true>(RT_ARGS)
                            : run<T, HD, false, true>(RT_ARGS);
    return RT_UNSUPPORTED;
  }
  return lse != nullptr ? run<T, HD, true, false>(RT_ARGS)
                        : run<T, HD, false, false>(RT_ARGS);
#undef RT_ARGS
}

template <typename T>
int launch_h(const void* q, const void* k, const void* v, void* o, float* lse,
             const float* slopes, int B, int Sq, int Sk, int Hq, int Hkv, int h,
             int causal, int win, float scale, cudaStream_t s) {
#define RT_ARGS q, k, v, o, lse, slopes, B, Sq, Sk, Hq, Hkv, causal, win, scale, s
  switch (h) {
    case 16: return launch<T, 16>(RT_ARGS);
    case 32: return launch<T, 32>(RT_ARGS);
    case 64: return launch<T, 64>(RT_ARGS);
    case 80: return launch<T, 80>(RT_ARGS);
    case 112: return launch<T, 112>(RT_ARGS);
    case 128: return launch<T, 128>(RT_ARGS);
  }
#undef RT_ARGS
  return RT_UNSUPPORTED;
}

}  // namespace

// q, o: (B, Sq, Hq, h); k, v: (B, Sk, Hkv, h); all contiguous, one dtype,
// 16-byte aligned when fp32 (cp.async); lse: (B, Hq, Sq) fp32, or null;
// slopes: Hq fp32 ALiBi slopes, or null; window: keys a row sees back from
// itself (0 = all).  Returns a cudaError_t, or RT_UNSUPPORTED for what the
// kernel does not take (h outside {16, 32, 64, 80, 112, 128}, Hq not a
// multiple of Hkv, a grid dimension over its limit, a negative window,
// slopes with a dtype other than fp32).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, float* lse, const float* slopes, int B, int Sq,
                                  int Sk, int Hq, int Hkv, int h, int causal, int window,
                                  float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535 || window < 0)
    return RT_UNSUPPORTED;
  const int win = window > 0 ? window : INT_MAX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#define RT_ARGS q, k, v, o, lse, slopes, B, Sq, Sk, Hq, Hkv, h, causal, win, scale, s
    case RT_F32: return launch_h<float>(RT_ARGS);
    case RT_BF16: return launch_h<__nv_bfloat16>(RT_ARGS);
    case RT_F16: return launch_h<__half>(RT_ARGS);
#undef RT_ARGS
  }
  return RT_UNSUPPORTED;
}
