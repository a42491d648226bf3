// Batched complex-to-complex Stockham FFT along axis -2 of split f32 planes
// (pre, n, L) -> (pre, n, L), one or two radix stages.  Hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package's axis -2 form:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_inner, reached through
// _make_call_inner.  Multi-axis plans run every non-last axis through it with
// a reshape and no transpose, and the four-step runs its p pass through it.
// It computes what _stages computes for each of the L columns, in the same
// autosorted order (the stage loop is stockham_stage.cuh).  Unnormalized.
//
// What bounds it on an H100: like the last-axis kernel, 16 bytes of HBM
// traffic per point against a dense p-term complex sum per output.  The
// design keeps the HBM side at one read and one write per point: a block
// takes a (n, tl) tile (tl consecutive columns of one pre index) into shared
// memory, runs every stage there, and the last stage writes straight to the
// output.  Columns are independent, so the edge tile (L not a multiple of tl)
// is masked: its missing columns are zero in shared memory and never stored.
// Nothing is padded.
//
// Tile width: the wrapper picks tl (a power of two) so that n*tl <= 8192
// points, two split buffers of 64 KB each; tl = 4 at n = 2048, 16 at
// n = 512, up to 128 for small n, and no wider than L needs.  A row segment
// of the tile is tl*4 bytes: at n = 2048 that is 16 bytes, half of a 32-byte
// sector, so the loads and stores there move twice the bytes they use.
//
// Blocks walk the (pre x tiles) grid with a grid stride, so any pre and L
// work; offsets into the planes are 64-bit.

#include "stockham_stage.cuh"

namespace {

using fftw3_tpu_torch::run_stages;
using fftw3_tpu_torch::Schedule;

constexpr int kThreads = 512;
// largest tile, in points (n * tl)
constexpr int kTilePoints = 8192;

// Last stage's store: point o of column c of the tile, inside the L edge
// (counted from element (b, 0, l0)).
struct ColMap {
  int64_t L;
  int width;  // columns of this tile inside L
  __device__ __forceinline__ bool stored(int c) const { return c < width; }
  __device__ __forceinline__ int64_t operator()(int, int o, int c) const {
    return o * L + c;
  }
};

__global__ void __launch_bounds__(kThreads)
inner_c2c_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float* __restrict__ tab, int tab_len, int pre, int n,
                 int64_t L, int tl, int nstages, int p0, int p1) {
  extern __shared__ float smem[];
  float* tb = smem;
  const int per = n * tl;
  float* ar = smem + tab_len;
  float* ai = ar + per;
  float* br = ai + per;
  float* bi = br + per;

  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const Schedule sched(tb, n, nstages, p0, p1);

  const int64_t ntiles = (L + tl - 1) / tl;
  const int64_t nblocks = ntiles * pre;
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int64_t b = blk / ntiles;
    const int64_t l0 = (blk - b * ntiles) * tl;
    const int width = static_cast<int>(L - l0 < tl ? L - l0 : tl);
    const int64_t base = b * n * L + l0;
    __syncthreads();  // tables staged; previous tile's readers are done
    for (int e = threadIdx.x; e < per; e += blockDim.x) {
      const int i = e / tl;
      const int c = e - i * tl;
      float vr = 0.f, vi = 0.f;
      if (c < width) {
        vr = xr[base + i * L + c];
        vi = xi[base + i * L + c];
      }
      ar[e] = vr;
      ai[e] = vi;
    }
    __syncthreads();
    run_stages(ar, ai, br, bi, sched, tl, 1, yr + base, yi + base,
               ColMap{L, width});
  }
}

}  // namespace

// Both entry points act on the caller's current device; the caller sets it.

// The most dynamic shared memory any valid schedule asks for: root tables of
// at most 2*256 + 2*2048 + 2*256 floats and four planes of kTilePoints floats
// (151552 bytes).
constexpr int kMaxSmem = static_cast<int>(sizeof(float)) *
                         (2 * 256 + 2 * 2048 + 2 * 256 + 4 * kTilePoints);

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device and report how many blocks of `smem` bytes fit on one SM.  Returns
// the CUDA error code, 0 on success.
extern "C" int inner_c2c_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      inner_c2c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, inner_c2c_kernel, kThreads, static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream`.  Returns the CUDA error code of the
// launch, 0 on success.  The caller checks shapes: pre >= 1, L >= 1,
// n = p0 or p0 * p1 with n <= 2048 and radices <= 256, n * tl <= 8192,
// tab_len matching the table layout, smem = 4 * (tab_len + 4 * n * tl) bytes,
// allowed by inner_c2c_occupancy.
extern "C" int inner_c2c_launch(const float* xr, const float* xi, float* yr,
                                float* yi, const float* tab, int tab_len,
                                int pre, int n, long long L, int tl,
                                int nstages, int p0, int p1, int grid,
                                int smem, void* stream) {
  if (n * tl > kTilePoints) return static_cast<int>(cudaErrorInvalidValue);
  inner_c2c_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, tab, tab_len, pre, n, static_cast<int64_t>(L), tl,
      nstages, p0, p1);
  return static_cast<int>(cudaGetLastError());
}
