// Batched 1-D complex-to-complex Stockham FFT along the last axis, one or two
// radix stages, split f32 planes.  Hand-written for Hopper (sm_90a).
//
// Replaces the fused Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel (the last-axis form) and its stage
// loop _stages, reached through _make_call, with _make_call's two four-step
// options.  It computes exactly what _stages computes, in the same autosorted
// order (the stage loop is stockham_stage.cuh, shared with the axis -2 and
// fused 2-D kernels).  The transform is unnormalized.
//
// The four-step options (build_pallas_c2c_split_fourstep):
//  * pretwiddle (ptw != nullptr, ptw_p = P): row r of the input is multiplied
//    point by point by w[k1, j] = exp(sign*2*pi*i*k1*j/(P*n)), k1 = r mod P,
//    as it is loaded.  w is a (P, n) table (re then im) built on the host in
//    f64, the reference's own constant; it is read from global memory (at
//    most 2 MB, L2-resident; shared memory keeps its size per launch).
//  * store_transposed (store_p = P): row r = b*P + k1 writes its point k2 to
//    out[b, k2, k1] of a (rows/P, n, P) output: the four-step's reorder folded
//    into the store.  Neighbouring threads then write P floats apart, so the
//    store is not coalesced; the reference uses it only at P = 128.
//
// What bounds it on an H100: the data moves once, 8 bytes read and 8 bytes
// written per point (16 B per point in all) against 3.35 TB/s of HBM; the
// arithmetic is a dense p-term complex sum per output, 4*p FP32 FMAs per
// point per stage (n = 1024 as [64, 16]: 320 FMAs per point, about twice the
// memory floor at the card's FP32 rate), and each complex term also loads
// four words from shared memory.  The design answers the memory side: a
// block holds whole rows in shared memory through every stage, so HBM sees
// one coalesced read and one coalesced write per point and nothing in
// between.  The arithmetic side is left plain on purpose (the dense sum, no
// butterflies): this is the simple form that is right first.
//
// Layout and schedule:
//  * A block walks rows with a grid stride, so any batch works with no
//    padding; row offsets are 64-bit.
//  * Each row lives as split planes in shared memory (n <= 2048: 16 KB per
//    plane pair).  The first stage reads the loaded row and writes a second
//    buffer; the last stage (q == 1 there, so its output index is the thread's
//    own index) writes straight to global memory, coalesced.
//  * No (2p x 2p) G matrix is stored: at p = 256 it would take 512 KB.  The
//    root tables (stockham_stage.cuh) sit in shared memory.

#include <initializer_list>

#include "stockham_stage.cuh"

namespace {

using fftw3_tpu_torch::run_stages;
using fftw3_tpu_torch::Schedule;

constexpr int kThreads = 256;

// Last stage's store, natural order: point o of the row.
struct RowMap {
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int operator()(int, int o, int) const {
    return o;
  }
};

// Last stage's store, transposed: row b*P + k1 writes point k2 to
// out[b, k2, k1] of a (rows/P, n, P) output (counted from out[b, 0, k1]).
struct RowMapTransposed {
  int p;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int64_t operator()(int, int o, int) const {
    return static_cast<int64_t>(o) * p;
  }
};

// The plain kernel and the four-step's two forms are separate
// instantiations, so the plain form's loads and stores are those of a kernel
// without the options.
template <bool kPretwiddle, bool kTransposed>
__global__ void __launch_bounds__(kThreads)
stockham_c2c_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    float* __restrict__ yr, float* __restrict__ yi,
                    const float* __restrict__ tab, int tab_len, int rows,
                    int n, int nstages, int p0, int p1,
                    const float* __restrict__ ptw, int ptw_p) {
  extern __shared__ float smem[];
  float* tb = smem;
  float* ar = smem + tab_len;
  float* ai = ar + n;
  float* br = ai + n;
  float* bi = br + n;

  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const Schedule sched(tb, n, nstages, p0, p1);

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t off = static_cast<int64_t>(row) * n;
    __syncthreads();  // tables staged; previous row's readers are done
    if (!kPretwiddle) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        ar[i] = xr[off + i];
        ai[i] = xi[off + i];
      }
    } else {
      const float* wr = ptw + static_cast<int64_t>(row % ptw_p) * n;
      const float* wi = wr + static_cast<int64_t>(ptw_p) * n;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float a = xr[off + i];
        const float b = xi[off + i];
        const float c = wr[i];
        const float d = wi[i];
        ar[i] = a * c - b * d;
        ai[i] = a * d + b * c;
      }
    }
    __syncthreads();
    if (kTransposed) {
      const int b = row / ptw_p;
      const int64_t toff =
          static_cast<int64_t>(b) * n * ptw_p + (row - b * ptw_p);
      run_stages(ar, ai, br, bi, sched, 1, 1, yr + toff, yi + toff,
                 RowMapTransposed{ptw_p});
    } else {
      run_stages(ar, ai, br, bi, sched, 1, 1, yr + off, yi + off, RowMap{});
    }
  }
}

}  // namespace

// Both entry points act on the caller's current device; the caller sets it.

// The most dynamic shared memory any valid schedule asks for: root tables of
// at most 2*256 + 2*2048 + 2*256 floats and four planes of 2048 floats
// (53248 bytes, over the 48 KB a launch gets without opting in).
constexpr int kMaxSmem =
    static_cast<int>(sizeof(float)) * (2 * 256 + 2 * 2048 + 2 * 256 + 4 * 2048);

// Allow every form of the kernel kMaxSmem bytes of dynamic shared memory on
// the current device (always the same value, so no launch is ever capped
// below its own size by a later call) and report how many blocks of `smem`
// bytes fit on one SM.  Returns the CUDA error code, 0 on success.  Called
// once per (device, smem); the caller keeps the resulting grid size.
extern "C" int stockham_c2c_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  for (auto fn : {stockham_c2c_kernel<false, false>,
                  stockham_c2c_kernel<true, false>,
                  stockham_c2c_kernel<true, true>}) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, stockham_c2c_kernel<false, false>, kThreads,
      static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream` (a cudaStream_t passed as a pointer).
// Returns the CUDA error code of the launch, 0 on success.  The caller checks
// shapes: rows >= 1, n = p0 (one stage) or n = p0 * p1 (two stages),
// n <= 2048, radices <= 256, tab_len matching the table layout, and
// smem = 4 * (tab_len + 4 * n) bytes, allowed by stockham_c2c_occupancy.
// ptw is nullptr (no pretwiddle) or a (ptw_p, n) re table followed by the im
// table; store_p is 0 or ptw_p, a divisor of rows.
extern "C" int stockham_c2c_launch(const float* xr, const float* xi,
                                   float* yr, float* yi, const float* tab,
                                   int tab_len, int rows, int n, int nstages,
                                   int p0, int p1, const float* ptw,
                                   int ptw_p, int store_p, int grid, int smem,
                                   void* stream) {
  auto fn = stockham_c2c_kernel<false, false>;
  if (ptw != nullptr)
    fn = store_p ? stockham_c2c_kernel<true, true>
                 : stockham_c2c_kernel<true, false>;
  else if (store_p)
    return static_cast<int>(cudaErrorInvalidValue);
  if (store_p && store_p != ptw_p)
    return static_cast<int>(cudaErrorInvalidValue);
  fn<<<grid, kThreads, static_cast<size_t>(smem),
       static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tab, tab_len,
                                            rows, n, nstages, p0, p1, ptw,
                                            ptw_p);
  return static_cast<int>(cudaGetLastError());
}
