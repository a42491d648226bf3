// Batched 1-D complex-to-complex Stockham FFT along the last axis, one or two
// radix stages, split f32 planes.  Hand-written for Hopper (sm_90a).
//
// Replaces the fused Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel (the last-axis form) and its stage
// loop _stages, reached through _make_call, with _make_call's two four-step
// options.  It computes what _stages computes, in the same autosorted order.
// The transform is unnormalized.
//
// The four-step options (build_pallas_c2c_split_fourstep):
//  * pretwiddle (ptw != nullptr, ptw_p = P): row r of the input is multiplied
//    point by point by w[k1, j] = exp(sign*2*pi*i*k1*j/(P*n)), k1 = r mod P,
//    as it is loaded.  w is a (P, n) table (re then im) built on the host in
//    f64, the reference's own constant, read from global memory (at most
//    2 MB, L2-resident).
//  * store_transposed (store_p = P): row r = b*P + k1 writes its point k2 to
//    out[b, k2, k1] of a (rows/P, n, P) output: the four-step's reorder folded
//    into the store (not coalesced; the reference uses it only at P = 128).
//
// What bounds it on an H100: the data moves once, 8 bytes read and 8 bytes
// written per point, 16 B per point against 3.35 TB/s of HBM (0.32 ms at
// (65536, 1024)).  The first form computed every stage as the dense p-term sum
// (4p FFMAs and 4p shared-memory words per point per stage: at [64, 16]
// 320 loads per point, most of its 3.9 ms).  This form runs each 2-3-5-smooth
// stage as register butterflies (stockham_bfly.cuh): 4 shared-memory words
// per point per register level (three levels at [64, 16]) and 5N log2 N
// flops in all, so the HBM traffic is the bound again.  A block takes
// several rows, so each barrier serves them all; the body is
// stockham_rows.cuh, which E5 (ablate_stage.cu) instantiates too.  A stage
// whose radix has a prime factor of 7 or more keeps the dense sum.
//
// The wide form (stockham_c2c_wide_*) is the same body at 512 threads, one
// row of up to 4096 points per block: the reference's MEASURE-only
// all-butterfly schedule [n/h, h] for 2048 < n <= 4096
// (fftw3_tpu/planner.py:494-506), plain form only.
//
// The plain form, narrow and wide, also reads an interleaved complex64
// input, writes an interleaved complex64 output, or both (`layout`, a
// template argument of the same kernel, stockham_rows.cuh): the complex
// entry of a plan hands its tensor to K1 and takes K1's output as its own,
// with no conversion pass around it.
//
// The in-place form (stockham_c2c_inplace_*) is the plain form with the
// output on the input, E10's `donate` arm (experiments/headline_gap.py),
// timing only: its planes are not __restrict__ and are not read through the
// read-only path.  It is no race: a block reads every row of its group (the
// load pass or the first level) before the barrier ahead of its last
// level's stores, and no two blocks share a row.

#include "stockham_rows.cuh"

using fftw3_tpu_torch::Arm;

namespace fftw3_tpu_torch {
namespace {

// Allow every form of the kernel at kThreads (plain, its layouts and, at
// kRowThreads, the four-step's) its shared memory and report how many
// blocks of `smem` bytes fit on one SM.
template <int kThreads>
int occupancy(int smem, int* blocks_per_sm) {
  const int err = rows_occupancy<Arm::kFull, kThreads>(smem, blocks_per_sm);
  if (err != 0) return err;
  return static_cast<int>(allow_layouts_smem<kThreads>());
}

// rows_launch at the run-time `layout` (bits kInC, kOutC).
template <int kThreads>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const float* tab, const int* plan, int rows, int n, int rpb,
           const float* ptw, int ptw_p, int store_p, int layout, int grid,
           int smem, cudaStream_t stream) {
  switch (layout) {
    case 0:
      return rows_launch<Arm::kFull, kThreads>(xr, xi, yr, yi, tab, plan,
                                               rows, n, rpb, ptw, ptw_p,
                                               store_p, grid, smem, stream);
    case kInC:
      return rows_launch<Arm::kFull, kThreads, kInC>(
          xr, xi, yr, yi, tab, plan, rows, n, rpb, ptw, ptw_p, store_p, grid,
          smem, stream);
    case kOutC:
      return rows_launch<Arm::kFull, kThreads, kOutC>(
          xr, xi, yr, yi, tab, plan, rows, n, rpb, ptw, ptw_p, store_p, grid,
          smem, stream);
    case kInC | kOutC:
      return rows_launch<Arm::kFull, kThreads, kInC | kOutC>(
          xr, xi, yr, yi, tab, plan, rows, n, rpb, ptw, ptw_p, store_p, grid,
          smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace fftw3_tpu_torch

// Both entry points act on the caller's current device; the caller sets it.

// Allow every form of the kernel (plain, interleaved and four-step) its
// shared memory and report how many blocks of `smem` bytes fit on one SM.
// Returns the CUDA error code.
extern "C" int stockham_c2c_occupancy(int smem, int* blocks_per_sm) {
  return fftw3_tpu_torch::occupancy<fftw3_tpu_torch::kRowThreads>(
      smem, blocks_per_sm);
}

// Launch `grid` blocks on `stream` (a cudaStream_t passed as a pointer):
// rows of n points in groups of rpb, on the level plan `plan` (host ints,
// stockham.level_plan) over the root tables `tab`.  `layout` 0 takes split
// planes in and out; adding 1 (kInC) makes xr an interleaved complex input
// (xi unused), adding 2 (kOutC) yr an interleaved complex output (yi
// unused), the plain form only.  Returns the CUDA error code of the launch, 0 on
// success; the contract is rows_launch's (stockham_rows.cuh).
extern "C" int stockham_c2c_launch(const float* xr, const float* xi,
                                   float* yr, float* yi, const float* tab,
                                   const int* plan, int rows, int n, int rpb,
                                   const float* ptw, int ptw_p, int store_p,
                                   int layout, int grid, int smem,
                                   void* stream) {
  return fftw3_tpu_torch::launch<fftw3_tpu_torch::kRowThreads>(
      xr, xi, yr, yi, tab, plan, rows, n, rpb, ptw, ptw_p, store_p, layout,
      grid, smem, static_cast<cudaStream_t>(stream));
}

// The wide form: rows of 2048 < n <= 4096 points, one per block, plain
// form only (ptw nullptr, store_p 0), any layout.  Same contracts as above.
extern "C" int stockham_c2c_wide_occupancy(int smem, int* blocks_per_sm) {
  return fftw3_tpu_torch::occupancy<fftw3_tpu_torch::kWideThreads>(
      smem, blocks_per_sm);
}

extern "C" int stockham_c2c_wide_launch(const float* xr, const float* xi,
                                        float* yr, float* yi,
                                        const float* tab, const int* plan,
                                        int rows, int n, int rpb,
                                        const float* ptw, int ptw_p,
                                        int store_p, int layout, int grid,
                                        int smem, void* stream) {
  return fftw3_tpu_torch::launch<fftw3_tpu_torch::kWideThreads>(
      xr, xi, yr, yi, tab, plan, rows, n, rpb, ptw, ptw_p, store_p, layout,
      grid, smem, static_cast<cudaStream_t>(stream));
}

namespace fftw3_tpu_torch {
namespace {

__global__ void __launch_bounds__(kRowThreads,
                                  kRowMinThreadsPerSm / kRowThreads)
stockham_c2c_inplace_kernel(float* xr, float* xi,
                            const float* __restrict__ tab,
                            const LevelPlan plan, int rows, int n, int rpb) {
  rows_body<Arm::kFull, false, false, true>(xr, xi, xr, xi, tab, plan, rows,
                                            n, rpb, nullptr, 0);
}

}  // namespace
}  // namespace fftw3_tpu_torch

// The in-place form: the plain form's contracts, with (xr, xi) both the
// input and the output.
extern "C" int stockham_c2c_inplace_occupancy(int smem, int* blocks_per_sm) {
  using namespace fftw3_tpu_torch;
  if (smem > kRowMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(stockham_c2c_inplace_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, stockham_c2c_inplace_kernel, kRowThreads,
      static_cast<size_t>(smem)));
}

extern "C" int stockham_c2c_inplace_launch(float* xr, float* xi,
                                           const float* tab, const int* plan,
                                           int rows, int n, int rpb, int grid,
                                           int smem, void* stream) {
  using namespace fftw3_tpu_torch;
  LevelPlan lp;
  if (!read_plan(plan, 1, &lp) || rpb < 1 || rpb * n > kRowPts * kRowThreads ||
      smem != plan_smem(lp, rpb))
    return static_cast<int>(cudaErrorInvalidValue);
  stockham_c2c_inplace_kernel<<<grid, kRowThreads, static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream)>>>(
      xr, xi, tab, lp, rows, n, rpb);
  return static_cast<int>(cudaGetLastError());
}
