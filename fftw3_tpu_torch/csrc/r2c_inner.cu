// Batched real-to-complex FFT along axis -2: real f32 (pre, n, L) -> split
// f32 planes (pre, n/2+1, L), n even.  Hand-written for Hopper (sm_90a).
//
// Replaces the axis -2 r2c Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_r2c_inner, reached through
// _make_call_r2c_inner.  It feeds the swapped rank-2 r2c composition
// (config.r2c_swapped): r2c over axis -2 first, then the last-axis c2c over
// the half spectrum's rows.  Forward only, as in the reference (no VJP).
//
// The transform is the one of r2c.cu, column by column: with m = n/2, row j
// of the pack is z[j, c] = x[2j, c] + i x[2j+1, c]; one complex m-point
// transform along the rows, then the untangle X[k] = A[k] + w[k] B[k],
// k = 0..m, per column,
//   A[k] = (Z[k] + conj Z[m-k]) / 2,  B[k] = -i (Z[k] - conj Z[m-k]) / 2,
// w[k] = exp(-2*pi*i*k/n) from the host in f64, cast to f32.
//
// What bounds it on an H100: the data moves once, 4 bytes read per real
// point and 8 bytes written per output bin (about 8 bytes per real point in
// all) against 3.35 TB/s of HBM: 0.080 ms at (8, 2048, 2048).  The first
// design ran the dense p-term sum of stockham_stage.cuh, 4p shared-memory
// words per point per stage, in four planes (1.202 ms there).
// This design is K2's tile (inner_c2c.cu) with K4's untangle (r2c.cu) along
// axis -2: the packed m-point transform of each column runs as the host's
// level plan for tiles of tl columns (stockham.level_plan(m, radices, tl)),
// each 2-3-5-smooth stage as the register butterfly levels of
// stockham_bfly.cuh (4 words per point per level; a radix with a prime
// factor of 7 or more keeps the dense sum), in place in one shared-memory
// buffer, one column's butterfly per thread, consecutive threads on
// consecutive columns.
//
// Per tile (tl consecutive columns of one pre index): a full tile whose plan
// starts with a butterfly level is read by that level straight from the two
// input rows of each packed row (re at row 2j, im at row 2j+1: points 2L
// apart, the even/odd split costs nothing); an edge tile, or a plan that
// starts with a dense stage, is loaded into the buffer first with the
// columns past L zero.  The last level stores Z into an unpadded Z region
// of its own (point o of column c at o*tl + c: the last level's stores run
// across a warp, and the untangle reads k and m - k, consecutive both
// ways); then the untangle writes bins 0..m straight to the output rows,
// tl consecutive floats of a row across a warp, the edge tile masked.
// Nothing is padded in HBM.
//
// Tile: 512 threads of up to 16 points in a level, m*tl <= 8192 points, tl
// a power of two (ops/real_stockham.py, r2c_inner_tile: tl = 8 at
// m = 1024), halved while the tables, the buffer and Z would pass kMaxSmem
// (a schedule with a dense stage, two buffers).  One block per SM, 128
// registers a thread, as K2.  Blocks walk the (pre x tiles) grid with a
// grid stride; offsets into the arrays are 64-bit.

#include "stockham_bfly.cuh"

namespace fftw3_tpu_torch {
namespace {

using fftw3_tpu_torch::Arm;
using fftw3_tpu_torch::Level;
using fftw3_tpu_torch::LevelPlan;
using fftw3_tpu_torch::kMaxLevels;
using fftw3_tpu_torch::read_plan;
using fftw3_tpu_torch::run_levels;
using fftw3_tpu_torch::stage_levels;

constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;
// points a thread holds in one level: tiles of 8192 points
constexpr int kPts = 16;
constexpr int kTilePoints = kPts * kThreads;
// a cap on any launch's shared memory (tables, buffers, Z), set once: under
// the 232448 bytes a block can opt into, room left for the static levels
constexpr int kMaxSmem = 230400;

// The last level's store: point o of column c to the Z region.
struct ZMap {
  int tl;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int operator()(int, int o, int c) const {
    return o * tl + c;
  }
};

// Shared-memory bytes of a launch (ops/real_stockham.py, r2c_inner_smem):
// the m-point tables and the w table, nbuf level buffers of two planes at
// stride rs, and Z, two planes of m * tl.
inline int r2c_inner_smem(const LevelPlan& plan, int m, int tl) {
  const int plane = (plan.rs + 3) & ~3;
  const int zplane = (m * tl + 3) & ~3;
  return static_cast<int>(sizeof(float)) *
         (((plan.tab_len + 2 * (m + 1) + 3) & ~3) + 2 * plan.nbuf * plane +
          2 * zplane);
}

// tab: the m-point tables (stockham._kernel_table layout, plan.tab_len
// floats) followed by re(w[0..m]) and im(w[0..m]).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
r2c_inner_kernel(const float* __restrict__ x, float* __restrict__ yr,
                 float* __restrict__ yi, const float* __restrict__ tab,
                 const LevelPlan plan, int pre, int n, int64_t L, int tl) {
  extern __shared__ float4 smem4[];
  __shared__ Level lev[kMaxLevels];
  const int m = n / 2;
  const int tab_len = plan.tab_len + 2 * (m + 1);
  float* tb = reinterpret_cast<float*>(smem4);
  const int plane = (plan.rs + 3) & ~3;
  float* ar = tb + ((tab_len + 3) & ~3);
  float* ai = ar + plane;
  float* br = ai + plane;  // second buffer, only with a dense stage
  float* bi = br + plane;
  float* zr = ar + 2 * plan.nbuf * plane;
  float* zi = zr + ((m * tl + 3) & ~3);
  const float* wr = tb + plan.tab_len;
  const float* wi = wr + (m + 1);
  stage_levels(plan, lev);
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const int tsh = __ffs(tl) - 1;  // tl is a power of two
  // a first level of butterflies reads full tiles from the input rows, its
  // offsets in int
  const bool direct_ok = plan.lev[0].kind != 0 &&
                         static_cast<int64_t>(n) * L < (int64_t{1} << 31);
  const int64_t ntiles = (L + tl - 1) / tl;
  const int64_t nblocks = ntiles * pre;
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int64_t b = blk / ntiles;
    const int64_t l0 = (blk - b * ntiles) * tl;
    const int width = static_cast<int>(L - l0 < tl ? L - l0 : tl);
    const float* xb = x + b * n * L + l0;
    const int64_t obase = b * (m + 1) * L + l0;
    const bool direct = direct_ok && width == tl;
    __syncthreads();  // levels and tables staged; the previous tile's
                      // untangle is done
    if (!direct) {
      for (int e = threadIdx.x; e < m * tl; e += blockDim.x) {
        const int j = e >> tsh;
        const int c = e & (tl - 1);
        float vr = 0.f, vi = 0.f;
        if (c < width) {
          vr = xb[(2 * j) * L + c];      // x[2j, c]
          vi = xb[(2 * j + 1) * L + c];  // x[2j+1, c]
        }
        ar[e] = vr;
        ai[e] = vi;
      }
      __syncthreads();
    }
    // packed point j of column c at x[2j, c] (re) and x[2j+1, c] (im)
    run_levels<kPts, Arm::kFull>(plan, lev, tb, ar, ai, br, bi, m, tl, 1, zr,
                                 zi, ZMap{tl}, direct ? xb : nullptr,
                                 direct ? xb + L : nullptr, 0,
                                 static_cast<int>(2 * L));
    __syncthreads();
    for (int e = threadIdx.x; e < (m + 1) * tl; e += blockDim.x) {
      const int k = e >> tsh;
      const int c = e & (tl - 1);
      if (c >= width) continue;
      const int k0 = k == m ? 0 : k;      // k mod m
      const int k1 = k == 0 ? 0 : m - k;  // (m - k) mod m
      const float za = zr[k0 * tl + c], zb = zi[k0 * tl + c];  // Z[k]
      const float zc = zr[k1 * tl + c], zd = zi[k1 * tl + c];  // Z[m-k]
      const float ur = 0.5f * (za + zc), ui = 0.5f * (zb - zd);  // A[k]
      const float vr = 0.5f * (zb + zd), vi = 0.5f * (zc - za);  // B[k]
      const float cr = wr[k], ci = wi[k];
      const int64_t o = obase + k * L + c;
      yr[o] = ur + cr * vr - ci * vi;
      yi[o] = ui + cr * vi + ci * vr;
    }
  }
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// Both entry points act on the caller's current device; the caller sets it.

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device (always the same value: the attribute is a cap) and report how
// many blocks of `smem` bytes fit on one SM.  Returns the CUDA error code,
// 0 on success.
extern "C" int r2c_inner_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      r2c_inner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, r2c_inner_kernel, kThreads, static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream` on the host's level plan `plan` of the
// m-point transform for tiles of tl columns (stockham.level_plan(n/2,
// radices, tl)).  Returns the CUDA error code of the launch, 0 on success.
// The caller checks shapes: pre >= 1, L >= 1, n even, tl a power of two
// with n/2 * tl <= kTilePoints, tab holding the plan's tab_len floats and
// the w table, smem = r2c_inner_smem(plan, n/2, tl), allowed by
// r2c_inner_occupancy.
extern "C" int r2c_inner_launch(const float* x, float* yr, float* yi,
                                const float* tab, const int* plan, int pre,
                                int n, long long L, int tl, int grid,
                                int smem, void* stream) {
  LevelPlan p;
  if (!read_plan(plan, tl, &p) || n % 2 || tl < 1 || (tl & (tl - 1)) ||
      (n / 2) * tl > kTilePoints || smem != r2c_inner_smem(p, n / 2, tl) ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  r2c_inner_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      x, yr, yi, tab, p, pre, n, static_cast<int64_t>(L), tl);
  return static_cast<int>(cudaGetLastError());
}
