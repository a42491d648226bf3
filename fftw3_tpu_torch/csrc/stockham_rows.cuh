// The body of K1, the batched last-axis c2c kernel (stockham_c2c.cu), as a
// template over E5's arm (ablate_stage.cu instantiates the timing-only
// arms), the four-step's two options, the block size and whether the planes
// alias the output (the in-place form of stockham_c2c.cu).  See
// stockham_c2c.cu for what it replaces and how it is bounded.
//
// Two block sizes, both at kRowPts points a thread in a level and 128
// registers a thread: kRowThreads (groups of up to 2048 points, two blocks
// per SM; every form) and kWideThreads (one row of up to 4096 points, one
// block per SM; the plain form only, for the reference's all-butterfly
// schedule above MAX_N).  A block takes groups of rpb whole rows (rpb * n
// <= kRowPts * kThreads points, the host's choice), walking the groups with
// a grid stride; the last group is ragged and masked, nothing is padded.  Per
// group: one pass of 16-byte loads (when n % 4 == 0 and the planes are
// 16-byte aligned, else 4-byte) into one shared-memory buffer, the
// pre-twiddle applied on the way; then the levels of the plan
// (stockham_bfly.cuh), in place, the last one storing straight to global
// memory through the row map (4-byte stores, coalesced across a warp).
// The plain form skips the load pass when the plan's first level is a
// butterfly level: that level reads its butterflies from global memory.
// Every index of a level is computed from the plan's ints at run time
// (stockham_bfly.cuh), so every schedule runs the same code.
//
// Layouts (kLayout, the plain form only): the input, the output or both may
// be one interleaved complex64 tensor, each point a float2 (re, im), passed
// as xr or yr (xi or yi unused): the complex entry's first and last pass, so
// that no conversion pass runs around the kernel.  An interleaved input is
// read by the first butterfly level as one 8-byte load a point, or by the
// load pass as 16-byte loads of two points (when n is even and the tensor
// 16-byte aligned, else 8-byte); an interleaved output is stored by the last
// level as one float2 a point.  The butterflies are the planes' own, in the
// same order on the same values.

#pragma once

#include "stockham_bfly.cuh"

namespace fftw3_tpu_torch {
namespace {

constexpr int kRowThreads = 256;
constexpr int kWideThreads = 512;
// the points a thread holds in one level (a group of rows holds kRowPts *
// kThreads points: stockham.ROW_TILE_POINTS, stockham.ROW_MAX_N), and the
// threads per SM the registers are held to, 512: 128 registers a thread,
// two blocks of kRowThreads (at three, 80, the levels spill more and run
// slower; PERF.md) or one of kWideThreads
constexpr int kRowPts = 8;
constexpr int kRowMinThreadsPerSm = 512;
// a cap on any plan's shared memory (tables, two buffers of up to
// kRowPts * kRowThreads points or one of kRowPts * kWideThreads, pads):
// set once per kernel
constexpr int kRowMaxSmem = 98304;

// Last level's store, natural order: point o of row r0 + row.
struct RowMap {
  int64_t r0;
  int n;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int64_t operator()(int row, int o, int) const {
    return (r0 + row) * n + o;
  }
};

// The same store of one float2 a point to an interleaved complex output.
struct RowMapC : RowMap {
  static constexpr bool kInterleaved = true;
};

// Last level's store, transposed: row b*P + k1 writes point k2 to
// out[b, k2, k1] of a (rows/P, n, P) output.
struct RowMapTransposed {
  int64_t r0;
  int n, p;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int64_t operator()(int row, int o, int) const {
    const int64_t r = r0 + row;
    const int64_t b = r / p;
    return b * n * p + (r - b * p) + static_cast<int64_t>(o) * p;
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float4 cmul4(float4 a, float4 b, float4 c,
                                        float4 d, float4* im) {
  // (a + ib) * (c + id), lane by lane
  *im = make_float4(a.x * d.x + b.x * c.x, a.y * d.y + b.y * c.y,
                    a.z * d.z + b.z * c.z, a.w * d.w + b.w * c.w);
  return make_float4(a.x * c.x - b.x * d.x, a.y * c.y - b.y * d.y,
                     a.z * c.z - b.z * d.z, a.w * c.w - b.w * d.w);
}

// A 16-byte load of the planes: through the read-only path, unless the
// planes alias the output (kAliased, the in-place form).
template <bool kAliased>
__device__ __forceinline__ float4 load_planes4(const float* p) {
  if constexpr (kAliased) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
}

// The load pass of an interleaved complex input: rows r0 .. r0 + nr of x
// (n points each) into the planes (ar, ai), rows rs apart; with vec two
// points a 16-byte load.
__device__ __forceinline__ void load_rows_c(const float2* x, int64_t r0,
                                            int nr, int n, float* ar,
                                            float* ai, int rs, bool vec) {
  if (vec) {
    const int n2 = n / 2;
    for (int i = threadIdx.x; i < nr * n2; i += blockDim.x) {
      const int row = i / n2;
      const int k = 2 * (i - row * n2);
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(x + (r0 + row) * n + k));
      *reinterpret_cast<float2*>(ar + row * rs + k) = make_float2(v.x, v.z);
      *reinterpret_cast<float2*>(ai + row * rs + k) = make_float2(v.y, v.w);
    }
  } else {
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
      const int row = i / n;
      const int k = i - row * n;
      const float2 v = __ldg(x + (r0 + row) * n + k);
      ar[row * rs + k] = v.x;
      ai[row * rs + k] = v.y;
    }
  }
}

// The body of every form.  The kernels that call it say whether the planes
// are __restrict__; kAliased (yr == xr, yi == xi) keeps read-only loads off
// the planes.
template <int kArm, bool kPretwiddle, bool kTransposed, bool kAliased,
          int kLayout = 0>
__device__ __forceinline__ void rows_body(const float* xr, const float* xi,
                                          float* yr, float* yi,
                                          const float* tab,
                                          const LevelPlan& plan, int rows,
                                          int n, int rpb, const float* ptw,
                                          int ptw_p) {
  constexpr bool kCin = (kLayout & kInC) != 0;
  constexpr bool kCout = (kLayout & kOutC) != 0;
  static_assert(kLayout == 0 || (kArm == Arm::kFull && !kPretwiddle &&
                                 !kTransposed && !kAliased),
                "interleaved layouts in the plain form only");
  extern __shared__ float4 smem4[];
  __shared__ Level lev[kMaxLevels];
  float* tb = reinterpret_cast<float*>(smem4);
  const int plane = (rpb * plan.rs + 3) & ~3;
  float* ar = tb + ((plan.tab_len + 3) & ~3);
  float* ai = ar + plane;
  float* br = ai + plane;  // second buffer, only with a dense stage
  float* bi = br + plane;
  stage_levels(plan, lev);
  for (int i = threadIdx.x; i < plan.tab_len; i += blockDim.x) tb[i] = tab[i];
  const bool vec =
      kCin ? n % 2 == 0 && plan.rs % 2 == 0 && aligned16(xr)
           : n % 4 == 0 && plan.rs % 4 == 0 && aligned16(xr) &&
                 aligned16(xi) && (!kPretwiddle || aligned16(ptw));
  const int groups = (rows + rpb - 1) / rpb;
  // a first level of butterflies reads the rows straight from global
  // memory (4-byte loads, coalesced across a warp), faster at (65536, 1024)
  // than the 16-byte load pass into shared memory that the other forms keep
  const bool direct = !kPretwiddle && kArm != Arm::kNoStage &&
                      plan.lev[0].kind != 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * rpb;
    const int nr = rows - r0 < rpb ? static_cast<int>(rows - r0) : rpb;
    __syncthreads();  // levels and tables staged; the previous group's
                      // readers are done
    if (!direct) {
      if constexpr (kCin) {
        load_rows_c(reinterpret_cast<const float2*>(xr), r0, nr, n, ar, ai,
                    plan.rs, vec);
      } else if (vec) {
        const int n4 = n / 4;
        for (int i = threadIdx.x; i < nr * n4; i += blockDim.x) {
          const int row = i / n4;
          const int k = 4 * (i - row * n4);
          const int64_t off = (r0 + row) * n + k;
          float4 a = load_planes4<kAliased>(xr + off);
          float4 b = load_planes4<kAliased>(xi + off);
          if (kPretwiddle) {
            const float* w =
                ptw + static_cast<int64_t>((r0 + row) % ptw_p) * n;
            const float4 c = __ldg(reinterpret_cast<const float4*>(w + k));
            const float4 d = __ldg(reinterpret_cast<const float4*>(
                w + static_cast<int64_t>(ptw_p) * n + k));
            a = cmul4(a, b, c, d, &b);
          }
          *reinterpret_cast<float4*>(ar + row * plan.rs + k) = a;
          *reinterpret_cast<float4*>(ai + row * plan.rs + k) = b;
        }
      } else {
        for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
          const int row = i / n;
          const int k = i - row * n;
          const int64_t off = (r0 + row) * n + k;
          float a = xr[off], b = xi[off];
          if (kPretwiddle) {
            const float* w =
                ptw + static_cast<int64_t>((r0 + row) % ptw_p) * n;
            const float c = w[k];
            const float d = w[static_cast<int64_t>(ptw_p) * n + k];
            const float t = a * c - b * d;
            b = a * d + b * c;
            a = t;
          }
          ar[row * plan.rs + k] = a;
          ai[row * plan.rs + k] = b;
        }
      }
      __syncthreads();
    }
    if constexpr (kArm == Arm::kNoStage) {
      for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
        const int row = i / n;
        const int k = i - row * n;
        yr[(r0 + row) * n + k] = ar[row * plan.rs + k];
        yi[(r0 + row) * n + k] = ai[row * plan.rs + k];
      }
    } else if constexpr (kTransposed) {
      run_levels<kRowPts, kArm>(plan, lev, tb, ar, ai, br, bi, n, 1, nr, yr,
                                yi, RowMapTransposed{r0, n, ptw_p});
    } else if constexpr (kLayout != 0) {
      // an interleaved input's row r0 starts at float 2 * r0 * n
      const float* x0 = direct ? xr + (kCin ? 2 : 1) * r0 * n : nullptr;
      const float* x0i = direct && !kCin ? xi + r0 * n : nullptr;
      if constexpr (kCout)
        run_levels<kRowPts, kArm, kCin>(plan, lev, tb, ar, ai, br, bi, n, 1,
                                        nr, yr, yi, RowMapC{{r0, n}}, x0, x0i,
                                        n);
      else
        run_levels<kRowPts, kArm, kCin>(plan, lev, tb, ar, ai, br, bi, n, 1,
                                        nr, yr, yi, RowMap{r0, n}, x0, x0i,
                                        n);
    } else {
      run_levels<kRowPts, kArm>(plan, lev, tb, ar, ai, br, bi, n, 1, nr, yr,
                                yi, RowMap{r0, n},
                                direct ? xr + r0 * n : nullptr,
                                direct ? xi + r0 * n : nullptr, n);
    }
  }
}

template <int kArm, bool kPretwiddle, bool kTransposed, int kThreads,
          int kLayout = 0>
__global__ void __launch_bounds__(kThreads, kRowMinThreadsPerSm / kThreads)
stockham_c2c_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    float* __restrict__ yr, float* __restrict__ yi,
                    const float* __restrict__ tab, const LevelPlan plan,
                    int rows, int n, int rpb, const float* __restrict__ ptw,
                    int ptw_p) {
  rows_body<kArm, kPretwiddle, kTransposed, false, kLayout>(
      xr, xi, yr, yi, tab, plan, rows, n, rpb, ptw, ptw_p);
}

using RowKernel = void (*)(const float*, const float*, float*, float*,
                          const float*, const LevelPlan, int, int, int,
                          const float*, int);

template <class Fn>
cudaError_t allow_smem(Fn fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kRowMaxSmem);
}

// Allow the kernel's form for arm kArm and block size kThreads (with kFull
// at kRowThreads also the four-step forms) kRowMaxSmem bytes of dynamic
// shared memory (always the same value, so no launch is capped below its
// own size by a later call) and report how many blocks of `smem` bytes fit
// on one SM.  Returns the CUDA error code, 0 on success.
template <int kArm, int kThreads = kRowThreads>
int rows_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kRowMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      allow_smem(stockham_c2c_kernel<kArm, false, false, kThreads>);
  if constexpr (kArm == Arm::kFull && kThreads == kRowThreads) {
    if (err == cudaSuccess)
      err = allow_smem(stockham_c2c_kernel<kArm, true, false, kThreads>);
    if (err == cudaSuccess)
      err = allow_smem(stockham_c2c_kernel<kArm, true, true, kThreads>);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, stockham_c2c_kernel<kArm, false, false, kThreads>,
      kThreads, static_cast<size_t>(smem)));
}

// Allow the plain form's interleaved layouts (kLayout 1-3) at block size
// kThreads kRowMaxSmem bytes of dynamic shared memory.
template <int kThreads>
cudaError_t allow_layouts_smem() {
  cudaError_t err = allow_smem(
      stockham_c2c_kernel<Arm::kFull, false, false, kThreads, kInC>);
  if (err == cudaSuccess)
    err = allow_smem(
        stockham_c2c_kernel<Arm::kFull, false, false, kThreads, kOutC>);
  if (err == cudaSuccess)
    err = allow_smem(stockham_c2c_kernel<Arm::kFull, false, false, kThreads,
                                         kInC | kOutC>);
  return err;
}

// Launch `grid` blocks of kThreads on `stream` on the host's level plan
// `plan_ints` (stockham.level_plan).  The caller checks shapes: rows >= 1,
// rpb * n within kRowPts * kThreads, smem = plan_smem(plan, rpb) allowed by
// rows_occupancy.  ptw is nullptr (no pre-twiddle) or, at kRowThreads, a
// (ptw_p, n) re table followed by the im table; store_p is 0 or ptw_p, a
// divisor of rows.  kLayout other than 0 (interleaved input or output,
// allowed by allow_layouts_smem) takes neither.  Returns the CUDA error
// code, 0 on success.
template <int kArm, int kThreads = kRowThreads, int kLayout = 0>
int rows_launch(const float* xr, const float* xi, float* yr, float* yi,
                const float* tab, const int* plan_ints, int rows, int n,
                int rpb, const float* ptw, int ptw_p, int store_p, int grid,
                int smem, cudaStream_t stream) {
  LevelPlan plan;
  if (!read_plan(plan_ints, 1, &plan) || rpb < 1 ||
      rpb * n > kRowPts * kThreads || smem != plan_smem(plan, rpb))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((ptw != nullptr &&
       (kArm != Arm::kFull || kThreads != kRowThreads || kLayout != 0)) ||
      (store_p && ptw == nullptr) || (store_p && store_p != ptw_p))
    return static_cast<int>(cudaErrorInvalidValue);
  RowKernel fn = stockham_c2c_kernel<kArm, false, false, kThreads, kLayout>;
  if constexpr (kArm == Arm::kFull && kThreads == kRowThreads &&
                kLayout == 0) {
    if (ptw != nullptr)
      fn = store_p ? stockham_c2c_kernel<kArm, true, true, kThreads>
                   : stockham_c2c_kernel<kArm, true, false, kThreads>;
  }
  fn<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      xr, xi, yr, yi, tab, plan, rows, n, rpb, ptw, ptw_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fftw3_tpu_torch
