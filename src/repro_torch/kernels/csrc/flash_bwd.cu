// Backward flash attention, causal or full, with grouped KV heads (GQA), an
// optional sliding window and optional ALiBi biases, on the tensor cores
// with fp32-exact products.
//
// The TPU kernel it pairs with, repro/kernels/flash.py::flash_attention (the
// pl.pallas_call at flash.py:79), has no backward: the reference trains
// through plain jnp attention.  The port's training path runs its forward
// kernel (flash.cu) on the card, so it needs this one.  From q, k, v, the
// forward's output o and its per-row log-sum-exp lse, and the output's
// gradient dO, with P = exp(scale * q kᵀ + bias - lse) recomputed tile by
// tile (bias = slope·(kpos − qpos) with ALiBi, else 0):
//   D  = rowsum(dO ∘ O)                    (flash_bwd_dot_kernel)
//   dV = Pᵀ dO,  dK = scale * dSᵀ Q        (flash_bwd_dkdv_kernel)
//   dQ = scale * dS K                      (flash_bwd_dq_kernel)
// where dP = dO Vᵀ and dS = P ∘ (dP - D).  Nothing of size Sq x Sk is ever
// written to device memory.
//
// Bound on the H100: operations.  Five products of 2·h flops per (query,
// key) pair the mask keeps (QKᵀ, dO Vᵀ, Pᵀ dO, dSᵀ Q, dS K) against
// 4 · 4 · h bytes per row of q, k, v, o, dO read and dq, dk, dv written.
// Every product runs on the TF32 tensor cores (mma.sync m16n8k8) in the
// 3xTF32 split of common.cuh, as flash.cu's do: in a CPU emulation
// (tests/test_torch_kernels.py) one TF32 product misses the 1e-4 of max|g|
// bound several times over and the split is as accurate as fp32.  So
// the ceiling is 495 / 3 TFLOP/s of fp32 work.  The dQ kernel recomputes S
// and dP, so this design does seven products for five (its own floor is
// 7/5 of the bound).
//
// Layout.  dK and dV are owned by one block per (batch, KV head, 128-key
// tile), which walks the 32-query tiles of all G query heads of its KV
// head and sums into registers: GQA's sum over the group needs no second
// pass and no atomics.  dQ is owned by one block per (batch, query head,
// 128-row query tile), which walks the 32-key tiles.  So every gradient is
// a plain sum in a fixed order, the same on every run.  Each kernel is the
// forward's structure turned around:
//   * each of the eight warps owns 16 rows (queries in the dQ kernel, keys
//     in the dK/dV kernel) and keeps their gradient rows in registers in
//     the MMA's C layout;
//   * S and dP (dQ kernel), Sᵀ and dPᵀ (dK/dV kernel) are computed into the
//     C layout; within each 8-wide step of the head dim the MMA's k = t and
//     k = t + 4 carry columns 2t and 2t + 1, so a lane's A and B pairs are
//     adjacent floats (8-byte loads);
//   * P = exp2(S·scale·log2 e − lse·log2 e) and dS = P ∘ (dP − D) are formed
//     in registers, split into big and small (again for each pair of the
//     second product's column steps), and feed the second product as its
//     A fragment with no shuffle: in each 8-key (8-query)
//     step the MMA's k = t and k = t + 4 carry keys (queries) 2t and
//     2t + 1, which is where the C layout left them.  lse and D are per
//     row in the dQ kernel (two registers each) and per column in the
//     dK/dV kernel (read from the staged tile's 32 values);
//   * each gradient tile's sum over a streamed tile (32 queries or keys)
//     is taken in the MMA from zero and added to the registers' running sum
//     in fp32 (tile_mma): the MMA's own accumulate rounds toward zero, a
//     bias that grows with the rows summed.  S and dP, sums over the head
//     dim only, accumulate in the MMA;
//   * the streamed tiles (K and V; Q, dO, lse and D) come in by cp.async
//     into a double buffer: tile j+1 is in flight while tile j's products
//     run.  bf16 and fp16 inputs are converted to fp32 by plain loads, as
//     flash.cu does;
//   * causal tiles no row can see are never loaded, a warp skips a tile
//     wholly outside its rows' mask, tiles wholly inside skip the tests,
//     and the blocks with the most tiles are launched first (the grid's
//     slow axis is the tile, reversed for the dQ kernel).
//
// Sliding window.  A window of W keys (key kpos is seen from row qpos when
// qpos − kpos < W, the reference's mask; 0 = none) is a run-time argument,
// as in the forward: W = INT_MAX for none, and the causal test and the
// window's are one unsigned compare, (unsigned)(qpos − kpos) < W, so the
// kernels without a window run the code they ran before, with one more
// compare per tile.  The dK/dV kernel's query tiles run from the block's
// first key (causal) to the tile of the last query that sees its last key,
// k0 + 127 + W − 1; the dQ kernel's key tiles start at the tile holding
// q0 − W + 1, the first key in its first row's window.  The warp-uniform
// skip and the inside test check the window's far edge beside the causal
// one.
//
// ALiBi (a per-query-head slope s, the score gaining s·(kpos − qpos)) is a
// template flag, built for fp32 only as the forward's is.  P is recomputed
// as exp2(fmaf(s·log2 e, kpos − qpos, S·scale·log2 e) − lse·log2 e), the
// forward's order of operations, the distance an exact float from the
// positions the mask already holds.  dS needs no bias term (the slopes are
// constants).  The dQ kernel reads its head's slope once; the dK/dV kernel
// walks all G query heads of its KV head, so it reads the slope of tile i's
// head, hk·G + i / per_head, once a tile.
//
// Shared-memory banks.  K in the dQ kernel and Q, dO in the dK/dV kernel
// are each read two ways: by row pairs, (row 8n + g, columns 2t, 2t + 1),
// as the B operand of QKᵀ-like products, and by column, (rows 2t, 2t + 1,
// column 8n + g), as the B operand of P·V-like products.  No pitch alone
// serves both (at h + 8 the column reads of t and t + 2 collide, at h + 4
// the 8-byte row reads of g and g + 1 overlap), so every tile here has
// rows of h + 8 floats and an XOR swizzle: on rows whose bit 2 is set,
// bit 3 of the column is flipped (a 16-byte chunk stays whole, so cp.async
// writes it as one piece).  Counted at the pitch mod 32 (136 ≡ 8 at
// h = 128, 120 ≡ 24 at h = 112): an 8-byte row read's half-warp (g in
// 0..3 or 4..7) starts at banks 8g + 2t (h = 128) or 24g + 2t (h = 112)
// plus one offset for the half: four distinct 8-bank groups; a column
// read starts at bank 2t·pitch + g + 8·[t ≥ 2] (+ pitch for row 2t + 1),
// which mod 32 is {0, 16, 8, 24} + g (row 2t) and {8, 24, 16, 0} + g (row
// 2t + 1) at h = 128 and {0, 16, 8, 24} + g and {24, 8, 0, 16} + g at
// h = 112: 32 distinct banks.  h = 16, 32, 64 have pitches ≡ 24, 8, 8, and
// h = 80's pitch of 88 is ≡ 24 as h = 112's 120 is, so the count for
// h = 112 holds for it unchanged.
//
// Shared memory at h = 128 (pitch 136, fp32): the dQ kernel keeps Q and dO
// of 128 rows (2 x 69.6 KB) and double-buffers K and V tiles of 32 keys
// (4 x 17.4 KB): 208,896 B; the dK/dV kernel keeps K and V of 128 keys and
// double-buffers Q and dO tiles of 32 queries with their lse and D
// (2 x 2 x 128 B): 209,408 B.  At h = 112, 184,320 and 184,832 B; at
// h = 80 (pitch 88), 135,168 and 135,680 B.  One block of eight warps per
// SM.
//
// Registers.  The dK/dV kernel holds dK and dV of 16 keys x h columns (2h/4
// registers a lane: 128 at h = 128, 80 at h = 80) beside Sᵀ and dPᵀ of 16
// keys x 32 queries (32 more) and a pair of column steps' tile sums (8);
// with the 32-query tile ptxas fits it in 255 with no spill in fp32 at
// h = 128, with ALiBi too (241 at h = 80), and at h = 112 with one column
// step at a time (tile_mma).  The half types' instantiation at h = 128
// spills (64 B; 28 B before the window's tests).  The dQ kernel holds dQ
// (h/4) and S, dP of 16 rows x 32 keys (32).
//
// Lengths need not be tile multiples: rows past Sq and keys past Sk are
// zero-filled by cp.async's source size and masked (but for the dK/dV
// kernel's own keys past Sk, whose rows feed only their own dK and dV rows,
// never stored).  The causal mask counts query and key positions from 0, as
// the forward's does.
#include <climits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;      // dQ kernel: query rows per block
constexpr int BKV = 16 * WARPS;     // dK/dV kernel: keys per block
constexpr int TK = 32;              // dQ kernel: keys per streamed K/V tile
constexpr int TQ = 32;              // dK/dV kernel: queries per streamed Q/dO tile
constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes from global to shared memory (the tile's lse and D); zeros where
// !valid.  The caller commits the group.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

// Where (row, col) of a tile lies: rows of LD floats, and on rows with bit
// 2 set, bit 3 of the column flipped.
template <int LD>
__device__ __forceinline__ int swz(int row, int col) {
  return row * LD + (col ^ ((row & 4) << 1));
}

// ROWS rows of HD elements, row r at src + (row0 + r) * stride, into the
// swizzled tile dst as fp32; rows at or past n are zeros.  fp32 goes by
// 16-byte cp.async (the caller commits); other types by plain loads.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride, int row0,
                                          int n) {
  static_assert(HD % 16 == 0, "the swizzle flips bit 3 inside 16-column groups");
  constexpr int CH = HD / 4;        // 4-element chunks per row
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 4;
    const bool in = row0 + r < n;
    const T* p = src + static_cast<size_t>(in ? row0 + r : 0) * stride + c;
    float* d = dst + swz<HD + 8>(r, c);
    if constexpr (std::is_same_v<T, float>) {
      cp_async16(d, p, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = in ? to_f(p[i]) : 0.f;
    }
  }
}

// A lane's row-pair reads of a swizzled tile: (row, 8d + 2t .. 8d + 2t + 1)
// as one float2 for each 8-column step d.  The swizzle moves even d by +s
// and odd d by -s (s = 8 on rows with bit 2 set), so each is one pointer
// and an immediate offset once d is unrolled.  ``roff`` adds whole rows of
// the same swizzle (a multiple of 8 rows).
struct RowPairs {
  const float* even;
  const float* odd;
  __device__ __forceinline__ RowPairs(const float* tile, int ld, int row, int t) {
    const int s = (row & 4) << 1;
    const float* base = tile + row * ld + 2 * t;
    even = base + s;
    odd = base - s;
  }
  __device__ __forceinline__ float2 at(int d, int roff) const {
    return *reinterpret_cast<const float2*>(((d & 1) ? odd : even) + 8 * d + roff);
  }
};

// A lane's column reads of a swizzled tile, the B operand of a product
// whose k runs over the tile's rows: (rows 8c + 2t and 8c + 2t + 1,
// column 8n + g) for each 8-row step c and 8-column step n.
template <int LD>
struct Cols {
  const float* even;
  const float* odd;
  __device__ __forceinline__ Cols(const float* tile, int g, int t) {
    const int s = ((2 * t) & 4) << 1;
    const float* base = tile + 2 * t * LD + g;
    even = base + s;
    odd = base - s;
  }
  __device__ __forceinline__ float2 at(int c, int n) const {
    const float* p = ((n & 1) ? odd : even) + 8 * c * LD + 8 * n;
    return make_float2(p[0], p[LD]);
  }
};

// The A fragment of 16 rows from registers in the C layout: this lane's
// (row, 2t), (row + 8, 2t), (row, 2t + 1), (row + 8, 2t + 1), split.
__device__ __forceinline__ void split_c(const float (&c)[4], uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// acc[n] += A·B over one tile's NC k-steps, for each 8-column step n of B
// (columns of a swizzled tile, the rows being k); A is 16 rows in the C
// layout (a[c] for k-step c).  The tile's sum is taken in the MMA from zero
// and added to acc in fp32, which rounds to nearest: the tensor core's
// accumulate rounds toward zero, and over the thousands of rows a gradient
// sums, accumulating in the MMA itself biases the sum (dv erred by 7.3e-5
// of max|g| at B = 4, S = 2048 and by 1.6e-4 at S = 8192 on an H100,
// against 9.2e-7 and 1.5e-6 this way; tools/bwd_variants.py).  Column
// steps go in pairs, each pair's two MMA chains independent, with A split
// again for each pair: on an H100 80GB HBM3 at 700 W pairs beat one step
// at a time by 3 %.  At h = 112 (NH = 14) they go one at a time: there,
// with the window's tests, the dK/dV kernel's pairs need more than 255
// registers (ptxas spilled 12 B at <fp32, 112>), and one at a time do not.
template <int NC, int NH, int LD>
__device__ __forceinline__ void tile_mma(float (&acc)[NH][4], const float (&a)[NC][4],
                                         const Cols<LD>& b) {
  constexpr int NG = NH == 14 ? 1 : 2;
  static_assert(NH % NG == 0, "whole pairs of column steps");
#pragma unroll
  for (int n0 = 0; n0 < NH; n0 += NG) {
    float t[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) t[j][i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t big[4], small[4];
      split_c(a[c], big, small);
#pragma unroll
      for (int j = 0; j < NG; ++j) mma3(t[j], big, small, b.at(c, n0 + j));
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + j][i] += t[j][i];
  }
}

// The A fragment of 16 rows of a tile read by row pairs, split.
__device__ __forceinline__ void split_rows(const RowPairs& a, int d, int ld,
                                           uint32_t (&big)[4], uint32_t (&small)[4]) {
  const float2 lo = a.at(d, 0), hi = a.at(d, 8 * ld);
  split(lo.x, big[0], small[0]);
  split(hi.x, big[1], small[1]);
  split(lo.y, big[2], small[2]);
  split(hi.y, big[3], small[3]);
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

// dK and dV for the keys [k0, k0 + BKV) of KV head hk, summed over the G
// query heads of its group and every query tile the mask lets see them.
template <typename T, int HD, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ Dv,
                      const float* __restrict__ slopes, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int causal,
                      int win, float scale) {
  constexpr int LD = HD + 8, NH = HD / 8, NQ = TQ / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // BKV x LD
  float* Vs = Ks + BKV * LD;        // BKV x LD
  float* Qs = Vs + BKV * LD;        // two buffers of TQ x LD
  float* dOs = Qs + 2 * TQ * LD;    // two buffers of TQ x LD
  float* stats = dOs + 2 * TQ * LD; // two buffers of lse (TQ) then D (TQ)

  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int k0 = blockIdx.y * BKV;  // the early keys, seen by the most queries, first
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key = warp * 16 + g;    // this lane's keys in the tile: key, key + 8
  const int kpos[2] = {k0 + key, k0 + key + 8};
  const int warp_first = k0 + warp * 16, warp_last = warp_first + 15;
  const float sl2 = scale * kLog2e;
  const size_t q_stride = static_cast<size_t>(Hq) * HD;
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;

  // the tiles: G heads x the query tiles from qt0 (causal: earlier queries
  // see none of these keys) to the one holding the last query whose window
  // reaches the block's last key (exclusive end k0 + BKV - 1 + win)
  const int qt0 = causal ? k0 / TQ : 0;
  const int q_end = win < Sq - (k0 + BKV - 1) ? k0 + BKV - 1 + win : Sq;
  const int per_head = max((q_end + TQ - 1) / TQ - qt0, 0);
  const int ntiles = G * per_head;
  auto issue = [&](int i) {
    const int hq = hk * G + i / per_head, q0 = (qt0 + i % per_head) * TQ, buf = i & 1;
    const size_t q_base = (static_cast<size_t>(b) * Sq * Hq + hq) * HD;
    load_tile<T, HD, TQ>(Qs + buf * TQ * LD, q + q_base, q_stride, q0, Sq);
    load_tile<T, HD, TQ>(dOs + buf * TQ * LD, dO + q_base, q_stride, q0, Sq);
    const size_t row_base = (static_cast<size_t>(b) * Hq + hq) * Sq;
    if (threadIdx.x < 2 * TQ) {
      const int r = threadIdx.x % TQ;
      const bool in = q0 + r < Sq;
      const float* src = (threadIdx.x < TQ ? lse : Dv) + row_base + (in ? q0 + r : 0);
      cp_async4(stats + buf * 2 * TQ + threadIdx.x, src, in);
    }
  };

  load_tile<T, HD, BKV>(Ks, k + kv_base, kv_stride, k0, Sk);
  load_tile<T, HD, BKV>(Vs, v + kv_base, kv_stride, k0, Sk);
  if (ntiles > 0) issue(0);
  cp_async_commit();

  float dK[NH][4], dV[NH][4];       // keys key, key + 8; columns 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dK[n][i] = dV[n][i] = 0.f;

  const RowPairs ka(Ks, LD, key, t), va(Vs, LD, key, t);
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {           // the next tile flies while this one runs
      issue(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                // tile j (and K, V) visible to every warp

    const int q0 = (qt0 + j % per_head) * TQ;
    // warp-uniform: some query of the tile sees one of the warp's keys
    if (warp_first < Sk && (!causal || warp_first <= q0 + TQ - 1) && q0 - warp_last < win) {
      const float* Qt = Qs + (j & 1) * TQ * LD;
      const float* dOt = dOs + (j & 1) * TQ * LD;
      const float* lse_t = stats + (j & 1) * 2 * TQ;
      const float* D_t = lse_t + TQ;

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys x TQ queries per warp, C layout
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      const RowPairs qb(Qt, LD, g, t), db(dOt, LD, g, t);
#pragma unroll
      for (int d = 0; d < NH; ++d) {
        uint32_t k_big[4], k_small[4], v_big[4], v_small[4];
        split_rows(ka, d, LD, k_big, k_small);
        split_rows(va, d, LD, v_big, v_small);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          mma3(s[n], k_big, k_small, qb.at(d, 8 * n * LD));
          mma3(dp[n], v_big, v_small, db.at(d, 8 * n * LD));
        }
      }

      // Pᵀ and dSᵀ in place of Sᵀ and dPᵀ; lse and D per query (column); a
      // tile wholly inside the mask (and every key's window) skips the tests.
      // Keys past Sk are not masked: their rows of Pᵀ and dSᵀ feed only their
      // own rows of dK and dV, which are never stored (the test cost the
      // h = 112 kernels registers they did not have)
      const bool inside = q0 + TQ <= Sq && (!causal || warp_last <= q0) &&
                          q0 + TQ - 1 - warp_first < win;
      float slope2 = 0.f;           // this tile's head's slope, in log2 units
      if constexpr (ALIBI) slope2 = slopes[hk * G + j / per_head] * kLog2e;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * t);
        const float2 dd = *reinterpret_cast<const float2*>(D_t + 8 * n + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = q0 + 8 * n + 2 * t + (i & 1);
          const int kp = kpos[i / 2];
          const int d = qpos - kp;
          const bool ok = inside ||
                          (qpos < Sq &&
                           (causal ? static_cast<unsigned>(d) < static_cast<unsigned>(win)
                                   : d < win));
          const float lq = (i & 1) ? l2.y : l2.x, dq = (i & 1) ? dd.y : dd.x;
          float e;
          if constexpr (ALIBI)
            e = exp2f(fmaf(slope2, static_cast<float>(-d), s[n][i] * sl2) - lq * kLog2e);
          else
            e = exp2f(fmaf(s[n][i], sl2, -lq * kLog2e));
          const float p = ok ? e : 0.f;
          s[n][i] = p;
          dp[n][i] = p * (dp[n][i] - dq);
        }
      }

      // dV += Pᵀ dO, then dK += dSᵀ Q over the tile's queries, Pᵀ and dSᵀ
      // from registers as A fragments
      tile_mma(dV, s, Cols<LD>(dOt, g, t));
      tile_mma(dK, dp, Cols<LD>(Qt, g, t));
    }
    __syncthreads();                // tile j consumed before its buffer refills
  }
  cp_async_wait<0>();               // K and V, where no tile was issued

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] < Sk) {
      T* dkr = dk + kv_base + static_cast<size_t>(kpos[r]) * kv_stride + 2 * t;
      T* dvr = dv + kv_base + static_cast<size_t>(kpos[r]) * kv_stride + 2 * t;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        store2(dkr + 8 * n, dK[n][2 * r] * scale, dK[n][2 * r + 1] * scale);
        store2(dvr + 8 * n, dV[n][2 * r], dV[n][2 * r + 1]);
      }
    }
  }
}

// dQ for the query rows [q0, q0 + BQ) of head hq, over every key tile the
// mask lets them see.
template <typename T, int HD, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ Dv,
                    const float* __restrict__ slopes, T* __restrict__ dq, int Sq, int Sk,
                    int Hq, int Hkv, int causal, int win, float scale) {
  constexpr int LD = HD + 8, NH = HD / 8, NK = TK / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // BQ x LD
  float* dOs = Qs + BQ * LD;        // BQ x LD
  float* Ks = dOs + BQ * LD;        // two buffers of TK x LD
  float* Vs = Ks + 2 * TK * LD;     // two buffers of TK x LD

  const int hq = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest causal tiles first
  const int hk = hq / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = warp * 16 + g;    // this lane's rows in the tile: row, row + 8
  const int qpos[2] = {q0 + row, q0 + row + 8};
  const int warp_first = q0 + warp * 16, warp_last = warp_first + 15;
  const float sl2 = scale * kLog2e;
  float slope2 = 0.f;               // this head's slope, in log2 units
  if constexpr (ALIBI) slope2 = slopes[hq] * kLog2e;
  const size_t q_stride = static_cast<size_t>(Hq) * HD;
  const size_t kv_stride = static_cast<size_t>(Hkv) * HD;
  const size_t q_base = (static_cast<size_t>(b) * Sq * Hq + hq) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * Sk * Hkv + hk) * HD;
  const size_t row_base = (static_cast<size_t>(b) * Hq + hq) * Sq;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int ntiles = (k_end + TK - 1) / TK;
  const int j0 = max(0, q0 - win + 1) / TK;     // the first tile in a row's window
  load_tile<T, HD, BQ>(Qs, q + q_base, q_stride, q0, Sq);
  load_tile<T, HD, BQ>(dOs, dO + q_base, q_stride, q0, Sq);
  load_tile<T, HD, TK>(Ks + (j0 & 1) * TK * LD, k + kv_base, kv_stride, j0 * TK, Sk);
  load_tile<T, HD, TK>(Vs + (j0 & 1) * TK * LD, v + kv_base, kv_stride, j0 * TK, Sk);
  cp_async_commit();

  float l2[2], Dr[2];               // lse in log2 units and D of this lane's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qpos[r] < Sq;
    l2[r] = in ? lse[row_base + qpos[r]] * kLog2e : 0.f;
    Dr[r] = in ? Dv[row_base + qpos[r]] : 0.f;
  }

  float acc[NH][4];                 // rows row, row + 8; columns 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const RowPairs qa(Qs, LD, row, t), da(dOs, LD, row, t);
  for (int j = j0; j < ntiles; ++j) {
    const int k0 = j * TK;
    if (j + 1 < ntiles) {           // the next tile flies while this one runs
      const int nb = (j + 1) & 1;
      load_tile<T, HD, TK>(Ks + nb * TK * LD, k + kv_base, kv_stride, k0 + TK, Sk);
      load_tile<T, HD, TK>(Vs + nb * TK * LD, v + kv_base, kv_stride, k0 + TK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                // tile j (and Q, dO) visible to every warp

    // warp-uniform: the tile holds a key of one of the warp's rows
    if ((!causal || k0 <= warp_last) && k0 + TK - 1 > warp_first - win) {
      const float* Kt = Ks + (j & 1) * TK * LD;
      const float* Vt = Vs + (j & 1) * TK * LD;

      // S = Q Kᵀ and dP = dO Vᵀ: 16 rows x TK keys per warp, C layout
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      const RowPairs kb(Kt, LD, g, t), vb(Vt, LD, g, t);
#pragma unroll
      for (int d = 0; d < NH; ++d) {
        uint32_t q_big[4], q_small[4], o_big[4], o_small[4];
        split_rows(qa, d, LD, q_big, q_small);
        split_rows(da, d, LD, o_big, o_small);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          mma3(s[n], q_big, q_small, kb.at(d, 8 * n * LD));
          mma3(dp[n], o_big, o_small, vb.at(d, 8 * n * LD));
        }
      }

      // dS = P ∘ (dP − D) in place of S; a tile wholly inside the mask (and
      // every row's window) skips the tests
      const bool inside = k0 + TK <= Sk && (!causal || k0 + TK - 1 <= warp_first) &&
                          k0 > warp_last - win;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + 8 * n + 2 * t + (i & 1);
          const int r = i / 2;
          const int d = qpos[r] - kpos;
          const bool ok = inside ||
                          (kpos < Sk &&
                           (causal ? static_cast<unsigned>(d) < static_cast<unsigned>(win)
                                   : d < win));
          float e;
          if constexpr (ALIBI)
            e = exp2f(fmaf(slope2, static_cast<float>(-d), s[n][i] * sl2) - l2[r]);
          else
            e = exp2f(fmaf(s[n][i], sl2, -l2[r]));
          const float p = ok ? e : 0.f;
          s[n][i] = p * (dp[n][i] - Dr[r]);
        }

      // dQ += dS K over the tile's keys, dS from registers as A fragments
      tile_mma(acc, s, Cols<LD>(Kt, g, t));
    }
    __syncthreads();                // tile j consumed before its buffer refills
  }
  cp_async_wait<0>();               // Q and dO, where no tile was in a row's window

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] < Sq) {
      T* dqr = dq + q_base + static_cast<size_t>(qpos[r]) * q_stride + 2 * t;
#pragma unroll
      for (int n = 0; n < NH; ++n)
        store2(dqr + 8 * n, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((HD + 8) * (2 * BKV + 4 * TQ) + 4 * TQ);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (HD + 8) * (2 * BQ + 4 * TK);
}
static_assert(dkdv_smem<128>() == 209408 && dq_smem<128>() == 208896 &&
                  dkdv_smem<112>() == 184832 && dq_smem<112>() == 184320 &&
                  dkdv_smem<80>() == 135680 && dq_smem<80>() == 135168,
              "the layout's bytes stated in the header note");

template <typename T, int HD, bool ALIBI>
int run(const void* q, const void* k, const void* v, const void* o, const void* dO,
        const float* lse, const float* slopes, float* Dv, void* dq, void* dk, void* dv, int B,
        int Sq, int Sk, int Hq, int Hkv, int causal, int win, float scale,
        cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dO);
  const size_t rows = static_cast<size_t>(B) * Sq * Hq;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), gp, Dv, B, Sq, Hq, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kv_kernel = flash_bwd_dkdv_kernel<T, HD, ALIBI>;
  constexpr size_t kv_smem = dkdv_smem<HD>();
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<<<dim3(B * Hkv, (Sk + BKV - 1) / BKV), THREADS, kv_smem, stream>>>(
      qp, kp, vp, gp, lse, Dv, slopes, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, Hq,
      Hkv, causal, win, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto q_kernel = flash_bwd_dq_kernel<T, HD, ALIBI>;
  constexpr size_t q_smem = dq_smem<HD>();
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kernel<<<dim3(B * Hq, (Sq + BQ - 1) / BQ), THREADS, q_smem, stream>>>(
      qp, kp, vp, gp, lse, Dv, slopes, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, causal, win,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
           const float* lse, const float* slopes, float* Dv, void* dq, void* dk, void* dv,
           int B, int Sq, int Sk, int Hq, int Hkv, int causal, int win, float scale,
           cudaStream_t stream) {
#define RT_ARGS q, k, v, o, dO, lse, slopes, Dv, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, win, \
                scale, stream
  if (slopes != nullptr) {          // ALiBi: fp32 only, as the forward
    if constexpr (std::is_same_v<T, float>) return run<T, HD, true>(RT_ARGS);
    return RT_UNSUPPORTED;
  }
  return run<T, HD, false>(RT_ARGS);
#undef RT_ARGS
}

template <typename T>
int launch_h(const void* q, const void* k, const void* v, const void* o, const void* dO,
             const float* lse, const float* slopes, float* Dv, void* dq, void* dk, void* dv,
             int B, int Sq, int Sk, int Hq, int Hkv, int h, int causal, int win, float scale,
             cudaStream_t s) {
#define RT_ARGS q, k, v, o, dO, lse, slopes, Dv, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, win, \
                scale, s
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

// q, o, dO, dq: (B, Sq, Hq, h); k, v, dk, dv: (B, Sk, Hkv, h); all contiguous,
// one dtype, 16-byte aligned when fp32 (cp.async).  lse: (B, Hq, Sq) fp32
// from the forward (rt_flash_attention, with the same window and slopes);
// slopes: Hq fp32 ALiBi slopes, or null; window: keys a row sees back from
// itself (0 = all); Dv: (B, Hq, Sq) fp32 scratch.  Returns a cudaError_t, or
// RT_UNSUPPORTED for what the kernels do not take (as rt_flash_attention,
// and B·Hq over 2^31 − 1 or more than 65535 tiles of 128 rows).
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dO, const float* lse,
                                      const float* slopes, float* Dv, void* dq, void* dk,
                                      void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int h,
                                      int causal, int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 ||
      Hq > 65535 || static_cast<long long>(B) * Hq > 0x7fffffff ||
      (Sq + BQ - 1) / BQ > 65535 || (Sk + BKV - 1) / BKV > 65535 || window < 0)
    return RT_UNSUPPORTED;
  const int win = window > 0 ? window : INT_MAX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_ARGS q, k, v, o, dO, lse, slopes, Dv, dq, dk, dv, B, Sq, Sk, Hq, Hkv, h, causal, win, \
                scale, s
  switch (dtype) {
    case RT_F32: return launch_h<float>(RT_ARGS);
    case RT_BF16: return launch_h<__nv_bfloat16>(RT_ARGS);
    case RT_F16: return launch_h<__half>(RT_ARGS);
  }
#undef RT_ARGS
  return RT_UNSUPPORTED;
}
