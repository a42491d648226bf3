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
// transform along the rows (the shared stage loop, stockham_stage.cuh, with a
// column stride), then the untangle X[k] = A[k] + w[k] B[k], k = 0..m,
//   A[k] = (Z[k] + conj Z[m-k]) / 2,  B[k] = -i (Z[k] - conj Z[m-k]) / 2,
// per column, w[k] = exp(-2*pi*i*k/n) from the host in f64, cast to f32.
//
// What bounds it on an H100: 4 bytes read per real point and 8 bytes written
// per output bin, once, against the dense p-term sum.  The tiling is the
// axis -2 c2c kernel's (inner_c2c.cu): a block holds an (m, tl) tile of
// packed points, tl consecutive columns of one pre index, in shared memory
// from the load through the stages and the untangle; the edge tile of an L
// that is not a multiple of tl is masked (its missing columns are zero in
// shared memory and never stored); nothing is padded.  The wrapper picks tl
// (a power of two) with m*tl <= 8192.  Blocks walk the (pre x tiles) grid
// with a grid stride; offsets into the arrays are 64-bit.

#include "stockham_stage.cuh"

namespace {

using fftw3_tpu_torch::run_stages;
using fftw3_tpu_torch::Schedule;
using fftw3_tpu_torch::SmemMap;

constexpr int kThreads = 512;
// largest tile, in packed points (m * tl)
constexpr int kTilePoints = 8192;

// tab: the m-point stage tables followed by re(w[0..m]) and im(w[0..m]).
__global__ void __launch_bounds__(kThreads)
r2c_inner_kernel(const float* __restrict__ x, float* __restrict__ yr,
                 float* __restrict__ yi, const float* __restrict__ tab,
                 int tab_len, int pre, int n, int64_t L, int tl, int nstages,
                 int p0, int p1) {
  extern __shared__ float smem[];
  const int m = n / 2;
  const int per = m * tl;
  float* tb = smem;
  float* ar = smem + tab_len;
  float* ai = ar + per;
  float* br = ai + per;
  float* bi = br + per;

  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const Schedule sched(tb, m, nstages, p0, p1);
  const float* wr = tb + tab_len - 2 * (m + 1);
  const float* wi = wr + (m + 1);
  float* zr = nstages == 1 ? br : ar;
  float* zi = nstages == 1 ? bi : ai;

  const int64_t ntiles = (L + tl - 1) / tl;
  const int64_t nblocks = ntiles * pre;
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int64_t b = blk / ntiles;
    const int64_t l0 = (blk - b * ntiles) * tl;
    const int width = static_cast<int>(L - l0 < tl ? L - l0 : tl);
    const float* xb = x + b * n * L + l0;
    const int64_t obase = b * (m + 1) * L + l0;
    __syncthreads();  // tables staged; previous tile's readers are done
    for (int e = threadIdx.x; e < per; e += blockDim.x) {
      const int j = e / tl;
      const int c = e - j * tl;
      float vr = 0.f, vi = 0.f;
      if (c < width) {
        vr = xb[(2 * j) * L + c];      // x[2j, c]
        vi = xb[(2 * j + 1) * L + c];  // x[2j+1, c]
      }
      ar[e] = vr;
      ai[e] = vi;
    }
    __syncthreads();
    run_stages(ar, ai, br, bi, sched, tl, 1, zr, zi, SmemMap{per, tl});
    __syncthreads();
    for (int e = threadIdx.x; e < (m + 1) * tl; e += blockDim.x) {
      const int k = e / tl;
      const int c = e - k * tl;
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

// Both entry points act on the caller's current device; the caller sets it.

// The most dynamic shared memory any valid schedule asks for: stage tables of
// at most 2*256 + 2*2048 + 2*256 floats, the w table of 2*2049 floats and
// four planes of kTilePoints floats (167944 bytes).
constexpr int kMaxSmem =
    static_cast<int>(sizeof(float)) *
    (2 * 256 + 2 * 2048 + 2 * 256 + 2 * 2049 + 4 * kTilePoints);

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device and report how many blocks of `smem` bytes fit on one SM.  Returns
// the CUDA error code, 0 on success.
extern "C" int r2c_inner_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      r2c_inner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, r2c_inner_kernel, kThreads, static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream`.  Returns the CUDA error code of the
// launch, 0 on success.  The caller checks shapes: pre >= 1, L >= 1, n even
// with m = n/2 = p0 or p0 * p1, m <= 2048, radices <= 256, m * tl <= 8192,
// tab_len = stage tables + 2 * (m + 1), and
// smem = 4 * (tab_len + 4 * m * tl) bytes, allowed by r2c_inner_occupancy.
extern "C" int r2c_inner_launch(const float* x, float* yr, float* yi,
                                const float* tab, int tab_len, int pre, int n,
                                long long L, int tl, int nstages, int p0,
                                int p1, int grid, int smem, void* stream) {
  if ((n / 2) * tl > kTilePoints)
    return static_cast<int>(cudaErrorInvalidValue);
  r2c_inner_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      x, yr, yi, tab, tab_len, pre, n, static_cast<int64_t>(L), tl, nstages,
      p0, p1);
  return static_cast<int>(cudaGetLastError());
}
