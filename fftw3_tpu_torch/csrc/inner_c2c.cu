// Batched complex-to-complex Stockham FFT along axis -2 of split f32 planes
// (pre, n, L) -> (pre, n, L), any schedule of one or two radix stages.
// Hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package's axis -2 form:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_inner, reached through
// _make_call_inner.  Multi-axis plans run every non-last axis through it with
// a reshape and no transpose, and the four-step runs its p pass through it.
// It computes what _stages computes for each of the L columns, in the same
// autosorted order.  Unnormalized.
//
// What bounds it on an H100: the data moves once, 8 bytes read and 8 bytes
// written per point, 16 bytes per point against 3.35 TB/s of HBM (0.64 ms at
// (1, 512, 262144)).  The dense p-term sum of stockham_stage.cuh would cost
// 4p shared-memory words per point per stage; each 2-3-5-smooth stage runs
// instead as the register butterfly levels of stockham_bfly.cuh, as in K1
// and K3, 4 words per point per level, so the HBM traffic is the bound
// again.  A radix with a prime factor of 7 or more keeps the dense sum.
//
// Design (the column pass of c2c_2d.cu, reading from the input): a block
// takes a group of gp planes of one (n, tl) tile each, tl consecutive
// columns of gp consecutive pre indices, and runs the host's level plan for
// tiles of tl columns (stockham.level_plan(n, radices, tl)) in place in one
// shared-memory buffer, one column's butterfly per thread, consecutive
// threads on consecutive columns.  A full tile whose plan starts with a
// butterfly level is read by that level straight from the input (4-byte
// loads, tl consecutive floats of a row across a warp), as K1 reads its
// rows; an edge tile, or a plan that starts with a dense stage, is loaded
// into the buffer first (16-byte loads when the tile is full and 16-byte
// aligned, else 4-byte).  The last level
// stores straight to the output (4-byte stores, tl consecutive floats of a
// row across a warp).  Columns are independent, so the edge tile (L not a
// multiple of tl) is masked: its missing columns are zero in shared memory
// and never stored.  Nothing is padded in HBM.
//
// Tile: 512 threads of up to 16 points in a level, 8192 points a group
// (inner.TILE_POINTS): tl = 16 at n = 512, 4 at n = 2048 (a row segment of
// 16 bytes, half a 32-byte sector), and gp > 1 only when one tile holds a
// whole plane (the four-step's (B, 32, 128) p pass: two planes a group).
// One block per SM, 128 registers a thread, as K3.
//
// Blocks walk the (groups x tiles) grid with a grid stride, so any pre and
// L work; offsets into the planes are 64-bit.
//
// An interleaved complex64 input (kLayout kInC, the same kernel): xr is the
// caller's complex tensor, each point a float2 (re, im), and xi is unused;
// the output stays in planes.  A tile's row segment is then 8 * tl
// contiguous bytes in place of two runs of 4 * tl: the first level reads a
// float2 a point, the load pass two points a 16-byte load (a full tile, tl
// and L even, the tensor 16-byte aligned; else 8-byte).  A multi-axis
// plan's first pass on a non-last axis reads the caller's tensor so, and no
// conversion pass runs ahead of it.
//
// An interleaved complex64 output (kLayout kOutC, with or without kInC):
// yr is a new complex tensor, yi is unused, and the last level stores a
// point as one float2 (re, im) through ColMapC, in place of one float in
// each plane: a tile's row segment is then 8 * tl contiguous bytes (32 at
// tl = 4) in place of two runs of 4 * tl.  The edge tile stays masked.  A
// plan's last pass on a non-last axis writes the caller's complex output
// so (a multi-axis r2c's K2 pass on the half spectrum), and no combine
// runs after it.  The four forms compute the same values; only the loads
// of the first level or the load pass and the stores of the last level
// differ.

#include "stockham_bfly.cuh"

namespace fftw3_tpu_torch {
namespace {

using fftw3_tpu_torch::Arm;
using fftw3_tpu_torch::Level;
using fftw3_tpu_torch::LevelPlan;
using fftw3_tpu_torch::kMaxLevels;
using fftw3_tpu_torch::plan_smem;
using fftw3_tpu_torch::read_plan;
using fftw3_tpu_torch::run_levels;
using fftw3_tpu_torch::stage_levels;

constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;
// points a thread holds in one level: groups of 8192 points
constexpr int kPts = 16;
constexpr int kTilePoints = kPts * kThreads;
// a cap on any plan's shared memory (tables, one padded buffer, or two
// unpadded with a dense stage), set once
constexpr int kMaxSmem = 180224;

// Last level's store: point o of column c of plane `row` of the group,
// inside the L edge (counted from element (b0, 0, l0)).
struct ColMap {
  int64_t base;
  int64_t plane;  // n * L
  int64_t L;
  int width;  // columns of this tile inside L
  __device__ __forceinline__ bool stored(int c) const { return c < width; }
  __device__ __forceinline__ int64_t operator()(int row, int o, int c) const {
    return base + row * plane + o * L + c;
  }
};

// The same store of one float2 a point to an interleaved complex output.
struct ColMapC : ColMap {
  static constexpr bool kInterleaved = true;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The load pass of one plane of an interleaved tile: n rows of tl columns
// of gc, rows L apart, into (sr, si) at i * tl + c (tl = 1 << tsh); with
// vec (a full tile) two columns a 16-byte load, else the columns from width
// on are zero.
__device__ __forceinline__ void load_tile_c(const float2* gc, int64_t L,
                                            int n, int tl, int tsh, int width,
                                            float* sr, float* si, bool vec) {
  if (vec) {
    const int t2sh = tsh - 1;
    const int c2 = (tl >> 1) - 1;
    for (int e = threadIdx.x; e < n * (tl >> 1); e += blockDim.x) {
      const int i = e >> t2sh;
      const int c = (e & c2) << 1;
      const float4 v = __ldg(reinterpret_cast<const float4*>(gc + i * L + c));
      *reinterpret_cast<float2*>(sr + (i << tsh) + c) = make_float2(v.x, v.z);
      *reinterpret_cast<float2*>(si + (i << tsh) + c) = make_float2(v.y, v.w);
    }
  } else {
    for (int e = threadIdx.x; e < n * tl; e += blockDim.x) {
      const int i = e >> tsh;
      const int c = e & (tl - 1);
      float2 v = make_float2(0.f, 0.f);
      if (c < width) v = __ldg(gc + i * L + c);
      sr[e] = v.x;
      si[e] = v.y;
    }
  }
}

template <int kLayout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
inner_c2c_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float* __restrict__ tab, const LevelPlan plan, int pre,
                 int n, int64_t L, int tl, int gp) {
  constexpr bool kCin = (kLayout & kInC) != 0;
  constexpr bool kCout = (kLayout & kOutC) != 0;
  static_assert((kLayout & ~(kInC | kOutC)) == 0, "layout bits");
  extern __shared__ float4 smem4[];
  __shared__ Level lev[kMaxLevels];
  float* tb = reinterpret_cast<float*>(smem4);
  const int plane = (gp * plan.rs + 3) & ~3;
  float* ar = tb + ((plan.tab_len + 3) & ~3);
  float* ai = ar + plane;
  float* br = ai + plane;  // second buffer, only with a dense stage
  float* bi = br + plane;
  stage_levels(plan, lev);
  for (int i = threadIdx.x; i < plan.tab_len; i += blockDim.x) tb[i] = tab[i];
  const int rs = plan.rs;
  const int64_t npl = static_cast<int64_t>(n) * L;
  const bool vec =
      kCin ? tl % 2 == 0 && L % 2 == 0 && rs % 2 == 0 && aligned16(xr)
           : tl % 4 == 0 && L % 4 == 0 && rs % 4 == 0 && aligned16(xr) &&
                 aligned16(xi);
  const int tsh = __ffs(tl) - 1;  // tl is a power of two
  // a first level of butterflies reads full tiles from the input, its
  // offsets in int
  const bool direct_ok = plan.lev[0].kind != 0 &&
                         gp * npl < (int64_t{1} << 31);
  const int64_t ntiles = (L + tl - 1) / tl;
  const int64_t nblocks = ntiles * ((pre + gp - 1) / gp);
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int64_t g = blk / ntiles;
    const int64_t l0 = (blk - g * ntiles) * tl;
    const int64_t b0 = g * gp;
    const int nr = static_cast<int>(pre - b0 < gp ? pre - b0 : gp);
    const int width = static_cast<int>(L - l0 < tl ? L - l0 : tl);
    const int64_t base = b0 * npl + l0;
    const bool direct = direct_ok && width == tl;
    __syncthreads();  // levels and tables staged; previous tile's readers
                      // are done
    for (int row = 0; row < nr && !direct; ++row) {
      if constexpr (kCin) {
        load_tile_c(reinterpret_cast<const float2*>(xr) + base + row * npl, L,
                    n, tl, tsh, width, ar + row * rs, ai + row * rs,
                    vec && width == tl);
        continue;
      }
      const float* gr = xr + base + row * npl;
      const float* gi = xi + base + row * npl;
      float* sr = ar + row * rs;
      float* si = ai + row * rs;
      if (vec && width == tl) {
        const int t4sh = tsh - 2;
        const int c4 = (tl >> 2) - 1;
        for (int e = threadIdx.x; e < n * (tl >> 2); e += blockDim.x) {
          const int i = e >> t4sh;
          const int c = (e & c4) << 2;
          const int64_t k = i * L + c;
          *reinterpret_cast<float4*>(sr + (i << tsh) + c) =
              __ldg(reinterpret_cast<const float4*>(gr + k));
          *reinterpret_cast<float4*>(si + (i << tsh) + c) =
              __ldg(reinterpret_cast<const float4*>(gi + k));
        }
      } else {
        for (int e = threadIdx.x; e < n * tl; e += blockDim.x) {
          const int i = e >> tsh;
          const int c = e & (tl - 1);
          float vr = 0.f, vi = 0.f;
          if (c < width) {
            vr = gr[i * L + c];
            vi = gi[i * L + c];
          }
          sr[e] = vr;
          si[e] = vi;
        }
      }
    }
    if (!direct) __syncthreads();
    // an interleaved input's element `base` starts at float 2 * base
    const ColMap map{base, npl, L, width};
    const float* x0r = direct ? xr + (kCin ? 2 : 1) * base : nullptr;
    const float* x0i = direct && !kCin ? xi + base : nullptr;
    if constexpr (kCout)
      run_levels<kPts, Arm::kFull, kCin>(
          plan, lev, tb, ar, ai, br, bi, n, tl, nr, yr, yi, ColMapC{map},
          x0r, x0i, static_cast<int>(npl), static_cast<int>(L));
    else
      run_levels<kPts, Arm::kFull, kCin>(
          plan, lev, tb, ar, ai, br, bi, n, tl, nr, yr, yi, map, x0r, x0i,
          static_cast<int>(npl), static_cast<int>(L));
  }
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// Both entry points act on the caller's current device; the caller sets it.

// The kernel of each layout, indexed by its bits.
using Kernel = decltype(&inner_c2c_kernel<0>);
static const Kernel kForms[4] = {inner_c2c_kernel<0>, inner_c2c_kernel<kInC>,
                                 inner_c2c_kernel<kOutC>,
                                 inner_c2c_kernel<kInC | kOutC>};

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device (always the same value: the attribute is a cap) and report how
// many blocks of `smem` bytes fit on one SM.  Returns the CUDA error code,
// 0 on success.
extern "C" int inner_c2c_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  for (const Kernel fn : kForms) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, inner_c2c_kernel<0>, kThreads,
      static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream` on the host's level plan `plan` for
// tiles of tl columns (stockham.level_plan(n, radices, tl)).  Returns the
// CUDA error code of the launch, 0 on success.  The caller checks shapes:
// pre >= 1, L >= 1, tl a power of two, gp * n * tl <= kTilePoints, tab
// holding the plan's tab_len floats, smem = plan_smem(plan, gp), allowed
// by inner_c2c_occupancy.  `layout` holds the bits kInC (xr an interleaved
// complex input, xi unused) and kOutC (yr an interleaved complex output, yi
// unused); 0 is split planes both ways.
extern "C" int inner_c2c_launch(const float* xr, const float* xi, float* yr,
                                float* yi, const float* tab, const int* plan,
                                int pre, int n, long long L, int tl, int gp,
                                int layout, int grid, int smem,
                                void* stream) {
  LevelPlan p;
  if (!read_plan(plan, tl, &p) || gp < 1 || (tl & (tl - 1)) ||
      gp * n * tl > kTilePoints || smem != plan_smem(p, gp) ||
      (layout & ~(kInC | kOutC)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel fn = kForms[layout];
  fn<<<grid, kThreads, static_cast<size_t>(smem),
       static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, tab, p, pre, n, static_cast<int64_t>(L), tl, gp);
  return static_cast<int>(cudaGetLastError());
}
