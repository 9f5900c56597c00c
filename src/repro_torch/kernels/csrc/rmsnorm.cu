// RMSNorm over the last dim: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Forward (rt_rmsnorm): the port of repro/kernels/rmsnorm.py::rmsnorm_pallas
// (_rmsnorm_kernel), which streams (256, D) row tiles through VMEM and fuses
// the mean-square reduce with the scale.
//
// Bound on the H100: bytes.  Two flops a byte is far below the card's
// ~20 fp32 flops per byte of HBM bandwidth, so the kernel can at best
// stream rows * D * sizeof(T) bytes in and as many out at 3.35 TB/s.
//
// Design.  Each row is read from device memory once, by 16-byte loads,
// held in registers through its reduction, and scaled and stored from
// them; each thread loads the scale of its columns once, by 16-byte loads,
// into registers as fp32, after its first row's loads are issued.  Who
// owns a row follows its width:
//   * up to 32 x 8 vectors (D <= 1024 fp32, <= 2048 in half types), a
//     warp: it reduces by shuffles alone and meets no barrier.  The grid
//     is persistent: as many blocks of 8 warps as fit on the card at once
//     (the runtime's occupancy times the SMs), or fewer where the rows run
//     out, each walking one contiguous run of rows, its warps taking 4 / NV
//     rows at a time in turn where a lane holds NV < 4 vectors of a row, so
//     a lane has at least 4 16-byte loads in flight.  The next rows are in
//     flight while the current ones are reduced: where a lane holds one
//     vector of a row (D <= 128 fp32), one thread fills a ring of
//     kRingStages shared-memory stages, each a contiguous run of whole rows
//     of about kStageBytes, by 1-D bulk copies (TMA) that complete on an
//     mbarrier, and refills a stage once the block has passed a barrier
//     after its last row; above that, each thread loads its vectors of the
//     next rows into a second set of registers before it reduces the
//     current ones (at 8 vectors a lane, 8 loads are in flight already, and
//     it loads the next rows after the current ones);
//   * wider rows, a block of up to 256 threads, each holding 2, 4 or 8
//     vectors, and a block for every row, which the card schedules as
//     blocks finish: the warps' sums meet in shared memory at one barrier.
// Each choice is the faster one measured (tools/rmsnorm_fwd_variants.py:
// a persistent grid for wide rows was slower, the register and ring feeds
// within a few per cent of each other).  A row is summed in fp32 in a fixed
// order, so the result is the same on every run and in every grid.  Where
// D is not a multiple of the 16-byte vector, x, y or the scale is not
// 16-byte aligned, or D is over 8 vectors a thread of 256, the same
// kernel's generic instantiation (NV = 0) takes the rows element by
// element: a block a row, the row read a second time to scale it, the
// scale read from device memory.
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

#include <mutex>
#include <vector>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
// the backward's blocks per SM: the register path holding up to 4 vectors
// a thread is held to the registers that let this many blocks of 256
// threads share an SM, and rt_rmsnorm_bwd_blocks launches one such wave
// (at 3, <fp32, 4 vectors> spilled and ran 5 % slower at (8192, 4096) on
// an H100 80GB HBM3 at 700 W; tools/bwd_variants.py)
constexpr int kBwdBlocksPerSM = 2;

// the forward's feeds of the warp-a-row path (head comment): the ring where
// a lane holds at most kRingMaxNV vectors of a row, registers above, as
// measured (tools/rmsnorm_fwd_variants.py)
enum Feed { kRegs = 0, kRing = 1 };
constexpr int kRingMaxNV = 1;
constexpr int kRingStages = 3;
constexpr int kStageBytes = 32 * 1024;

__host__ __device__ constexpr int narrow_feed(int nv) { return nv <= kRingMaxNV ? kRing : kRegs; }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks of `kernel` that fit on one SM at once with `threads` threads and
// `smem` bytes of dynamic shared memory, asked of the runtime once for each.
int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  struct Fit { const void* kernel; int threads; size_t smem; int blocks; };
  static std::mutex mu;
  static std::vector<Fit> known;
  std::lock_guard<std::mutex> lock(mu);
  for (const Fit& f : known)
    if (f.kernel == kernel && f.threads == threads && f.smem == smem) return f.blocks;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess
      || n < 1)
    n = 1;
  known.push_back({kernel, threads, smem, n});
  return n;
}

// Rows a warp takes at a time on the warp-a-row path, where each lane holds
// NV vectors of a row: enough for 4 16-byte loads in flight a lane.
__host__ __device__ constexpr int rows_per_warp(int nv) { return nv >= 4 ? 1 : 4 / nv; }

// Sums v over the block: warp shuffles, one word per warp in red (the
// caller passes one of two buffers in turn, so one barrier a call does),
// then every thread adds the warps' words in the same order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  return s;
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

// NV > 0: thread or lane t of a row's owner holds the row's 16-byte vectors
// t, t + owner size, ..., NV of them, and their scale in fp32.  A block a
// row (!WARP_ROWS): block b takes rows b, b + gridDim.x, ... (the grid has
// a block for each row).  A warp a row (WARP_ROWS): the block walks its run
// of `per` rows, [row0, row1), its warps taking RPW rows at a time in
// turn, fed by FEED (head comment); stage_rows is the rows of a ring
// stage.  NV = 0: the generic path, a block a row, element by element.
// (A minimum of 1 block an SM: without it ptxas spilled a predicate around
// the division's slow-path call at <fp32, 8, warp, regs>.)
template <typename T, typename S, int NV, bool WARP_ROWS, int FEED>
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
               int rows, int D, int per, int stage_rows, float eps) {
  constexpr int VEC = NV > 0 ? 16 / sizeof(T) : 1;
  constexpr int NR = NV > 0 ? NV : 1;
  constexpr int RPW = WARP_ROWS ? rows_per_warp(NR) : 1;
  using V = Vec<T, VEC>;
  __shared__ float red[2][kMaxThreads / 32];

  if constexpr (NV == 0) {
    int parity = 0;
    for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
      const T* xr = x + static_cast<size_t>(row) * D;
      T* yr = y + static_cast<size_t>(row) * D;
      float ss = 0.f;
      for (int i = threadIdx.x; i < D; i += blockDim.x) {
        const float f = to_f(xr[i]);
        ss += f * f;
      }
      const float r = rsqrtf(block_sum(ss, red[parity]) / static_cast<float>(D) + eps);
      for (int i = threadIdx.x; i < D; i += blockDim.x)
        yr[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));   // (x * r) * scale
    }
  } else {
    const int nvec = D / VEC;
    const int t = WARP_ROWS ? threadIdx.x & 31 : threadIdx.x;       // in the row's owner
    const int owner_size = WARP_ROWS ? 32 : blockDim.x;
    const V* xv = reinterpret_cast<const V*>(x);
    V* yv = reinterpret_cast<V*>(y);
    float s[NR][VEC];                     // the scale of this thread's vectors
    auto load_scale = [&]() {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = t + v * owner_size;
        if (c < nvec) load_f<S, VEC>(scale + static_cast<size_t>(c) * VEC, s[v]);
      }
    };
    // a[k] = the vectors of row k of the n (<= RPW) rows at p
    auto load = [&](V (&a)[RPW][NR], const V* p, int n) {
#pragma unroll
      for (int k = 0; k < RPW; ++k)
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = t + v * owner_size;
          if (k < n && c < nvec) a[k][v] = p[static_cast<size_t>(k) * nvec + c];
        }
    };
    // y of the n (<= RPW) rows from row g on, whose vectors a holds; a
    // block a row sums in red[parity]
    auto finish = [&](const V (&a)[RPW][NR], int g, int n, int parity) {
      float ss[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        ss[k] = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (k < n && t + v * owner_size < nvec)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float f = to_f(a[k][v].v[e]);
              ss[k] += f * f;
            }
      }
      if constexpr (WARP_ROWS) {
#pragma unroll
        for (int k = 0; k < RPW; ++k) ss[k] = warp_sum(ss[k]);
      } else {
        ss[0] = block_sum(ss[0], red[parity]);
      }
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const float r = rsqrtf(ss[k] / static_cast<float>(D) + eps);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = t + v * owner_size;
          if (k < n && c < nvec) {
            V o;
#pragma unroll
            for (int e = 0; e < VEC; ++e) o.v[e] = from_f<T>(to_f(a[k][v].v[e]) * r * s[v][e]);
            yv[static_cast<size_t>(g + k) * nvec + c] = o;
          }
        }
      }
    };

    if constexpr (!WARP_ROWS) {
      V a[1][NR];
      load(a, xv + static_cast<size_t>(blockIdx.x) * nvec, 1);   // the grid holds <= rows blocks
      load_scale();                       // while the first row is in flight
      int parity = 0;
      for (int g = blockIdx.x; g < rows; g += gridDim.x, parity ^= 1) {
        if (g != blockIdx.x) load(a, xv + static_cast<size_t>(g) * nvec, 1);
        finish(a, g, 1, parity);
      }
    } else {
      const int row0 = blockIdx.x * per;
      const int row1 = min(rows, row0 + per);
      const int owner = threadIdx.x >> 5;
      const int step = (blockDim.x >> 5) * RPW;                     // rows a sweep takes
      if constexpr (FEED == kRegs) {
        V a[RPW][NR];
        int g = row0 + owner * RPW;
        if (g < row1) load(a, xv + static_cast<size_t>(g) * nvec, row1 - g);
        load_scale();                     // while the first rows are in flight
        if constexpr (NR * RPW >= 8) {    // 8 loads in flight a lane already
          for (; g < row1; g += step) {
            finish(a, g, row1 - g, 0);
            if (g + step < row1)
              load(a, xv + static_cast<size_t>(g + step) * nvec, row1 - g - step);
          }
        } else {                          // the next rows into a second set
          V b[RPW][NR];
          for (; g < row1; g += 2 * step) {
            if (g + step < row1)
              load(b, xv + static_cast<size_t>(g + step) * nvec, row1 - g - step);
            finish(a, g, row1 - g, 0);
            if (g + step >= row1) break;
            if (g + 2 * step < row1)
              load(a, xv + static_cast<size_t>(g + 2 * step) * nvec, row1 - g - 2 * step);
            finish(b, g + step, row1 - g - step, 0);
          }
        }
      } else {
        extern __shared__ __align__(128) unsigned char smem[];
        V* stages = reinterpret_cast<V*>(smem);
        const size_t stage_vecs = static_cast<size_t>(stage_rows) * nvec;
        uint64_t* full = reinterpret_cast<uint64_t*>(stages + kRingStages * stage_vecs);
        const int chunks = (row1 - row0 + stage_rows - 1) / stage_rows;
        auto fill = [&](int i) {             // chunk i into its stage; thread 0 only
          const int c0 = row0 + i * stage_rows;
          const uint32_t bytes = static_cast<uint32_t>(min(row1 - c0, stage_rows)) * nvec * 16;
          uint64_t* bar = &full[i % kRingStages];
          mbar_expect_tx(bar, bytes);
          bulk_load(stages + (i % kRingStages) * stage_vecs,
                    xv + static_cast<size_t>(c0) * nvec, bytes, bar);
        };
        if (threadIdx.x == 0) {
          for (int st = 0; st < kRingStages; ++st) mbar_init(&full[st], 1);
          mbar_init_fence();
        }
        __syncthreads();                  // the barriers' inits
        if (threadIdx.x == 0)
          for (int i = 0; i < kRingStages && i < chunks; ++i) fill(i);
        load_scale();                     // while the first stages are in flight
        for (int i = 0; i < chunks; ++i) {
          mbar_wait(&full[i % kRingStages], (i / kRingStages) & 1);
          const int c0 = row0 + i * stage_rows, c1 = min(row1, c0 + stage_rows);
          const V* st = stages + (i % kRingStages) * stage_vecs;
          for (int g = c0 + owner * RPW; g < c1; g += step) {
            V a[RPW][NR];
            load(a, st + static_cast<size_t>(g - c0) * nvec, c1 - g);
            finish(a, g, c1 - g, 0);
          }
          __syncthreads();                // every thread is done with the stage
          if (threadIdx.x == 0 && i + kRingStages < chunks) fill(i + kRingStages);
        }
      }
    }
  }
}

template <typename T, typename S, int NV, bool WARP_ROWS, int FEED>
int run(const void* x, const void* scale, void* y, int rows, int D, float eps, int threads,
        cudaStream_t stream) {
  auto kernel = rmsnorm_kernel<T, S, NV, WARP_ROWS, FEED>;
  int nblocks = rows, per = 1, stage_rows = 0;   // a block a row
  size_t smem = 0;
  if (WARP_ROWS) {                        // a persistent grid of warps a row
    const int unit = threads / 32 * rows_per_warp(NV > 0 ? NV : 1);   // rows a sweep takes
    if (FEED == kRing) {
      const size_t row_bytes = static_cast<size_t>(D) * sizeof(T);
      stage_rows = static_cast<int>(kStageBytes / row_bytes) / unit * unit;
      if (stage_rows < unit) stage_rows = unit;
      smem = kRingStages * (stage_rows * row_bytes + sizeof(uint64_t));
    }
    static size_t smem_allowed = 48 * 1024;
    if (smem > smem_allowed) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_allowed = smem;
    }
    const int fit =
        blocks_per_sm(reinterpret_cast<const void*>(kernel), threads, smem) * sm_count();
    const int units = (rows + unit - 1) / unit;
    const int nblocks0 = units < fit ? units : fit;
    per = (units + nblocks0 - 1) / nblocks0 * unit;   // whole sweeps a block
    nblocks = (rows + per - 1) / per;
  }
  kernel<<<nblocks, threads, smem, stream>>>(static_cast<const T*>(x),
                                             static_cast<const S*>(scale), static_cast<T*>(y),
                                             rows, D, per, stage_rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int rows, int D, float eps,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = D / VEC;
  const bool vec_ok = D % VEC == 0 && nvec <= 8 * kMaxThreads && aligned16(x) &&
                      aligned16(y) && aligned16(scale);
#define RT_ARGS x, scale, y, rows, D, eps
  if (!vec_ok)
    return run<T, S, 0, false, kRegs>(RT_ARGS, D < kMaxThreads ? (D + 31) / 32 * 32
                                                                : kMaxThreads, stream);
  if (nvec <= 8 * 32) {                   // a warp a row
    switch (nvec <= 32 ? 1 : nvec <= 64 ? 2 : nvec <= 128 ? 4 : 8) {
      case 1: return run<T, S, 1, true, narrow_feed(1)>(RT_ARGS, kMaxThreads, stream);
      case 2: return run<T, S, 2, true, narrow_feed(2)>(RT_ARGS, kMaxThreads, stream);
      case 4: return run<T, S, 4, true, narrow_feed(4)>(RT_ARGS, kMaxThreads, stream);
      default: return run<T, S, 8, true, narrow_feed(8)>(RT_ARGS, kMaxThreads, stream);
    }
  }
  // a block a row
  const int nv = nvec <= 2 * kMaxThreads ? 2 : nvec <= 4 * kMaxThreads ? 4 : 8;
  const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
  switch (nv) {
    case 2: return run<T, S, 2, false, kRegs>(RT_ARGS, threads, stream);
    case 4: return run<T, S, 4, false, kRegs>(RT_ARGS, threads, stream);
    default: return run<T, S, 8, false, kRegs>(RT_ARGS, threads, stream);
  }
#undef RT_ARGS
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
  const int n = kBwdBlocksPerSM * sm_count();
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
