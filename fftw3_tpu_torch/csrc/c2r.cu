// Batched 1-D complex-to-real FFT along the last axis: split f32 planes
// (B, n/2+1) -> real f32 rows (B, n), n even, the unnormalized inverse of
// r2c.cu (c2r(r2c(x)) = n x).  Hand-written for Hopper (sm_90a).
//
// Replaces the fused c2r Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_c2r, reached through
// _make_call_c2r.  The reference runs two m-point inverse transforms
// (m = n/2) of X[0..m-1] and v^k X[0..m-1] and needs no index reversal.
// Here shared memory reverses for free, so the kernel takes the c2r pack of
// the reference's c2r_pack solver (fftw3_tpu/ops/real.py) instead:
//   E[k] = (X[k] + conj X[m-k]) / 2,  O[k] = (X[k] - conj X[m-k]) v[k] / 2,
//   Z[k] = E[k] + i O[k],  k = 0..m-1,  v[k] = exp(+2*pi*i*k/n),
// ONE complex inverse m-point transform z = T+(Z) through the shared stage
// loop (stockham_stage.cuh), and y[2j] = 2 Re z[j], y[2j+1] = 2 Im z[j].
// Im X[0] and Im X[m] are dropped first, as numpy, FFTW and the reference's
// kernel drop them.  v comes from the host in f64, cast to f32.
//
// What bounds it on an H100: like r2c.cu, one HBM read of the half spectrum
// (8 bytes per bin) and one write of the real rows (4 bytes per point)
// against the dense p-term sum of one m-point transform.  A block holds whole
// rows in shared memory from the load to the store; the half-spectrum rows
// have an odd length (n/2+1 floats), so they are loaded as scalars; each
// output pair (y[2j], y[2j+1]) is stored as one 8-byte float2, coalesced.
//
// Blocks walk rows with a grid stride; any batch works with no padding; row
// offsets are 64-bit.

#include "stockham_stage.cuh"

namespace {

using fftw3_tpu_torch::run_stages;
using fftw3_tpu_torch::Schedule;
using fftw3_tpu_torch::SmemMap;

constexpr int kThreads = 256;

// tab: the m-point stage tables (sign +1) followed by re(v[0..m]) and
// im(v[0..m]); tab_len counts both.  Shared planes hold m + 1 floats each,
// the length of a half-spectrum row.
__global__ void __launch_bounds__(kThreads)
c2r_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ y, const float* __restrict__ tab, int tab_len,
           int rows, int n, int nstages, int p0, int p1) {
  extern __shared__ float smem[];
  const int m = n / 2;
  float* tb = smem;
  float* ar = smem + tab_len;
  float* ai = ar + (m + 1);
  float* br = ai + (m + 1);
  float* bi = br + (m + 1);

  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const Schedule sched(tb, m, nstages, p0, p1);
  const float* vr = tb + tab_len - 2 * (m + 1);
  const float* vi = vr + (m + 1);
  // the last stage writes z here: after one stage (ar -> br), after two
  // (ar -> br -> ar)
  float* zr = nstages == 1 ? br : ar;
  float* zi = nstages == 1 ? bi : ai;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t off = static_cast<int64_t>(row) * (m + 1);
    __syncthreads();  // tables staged; previous row's readers are done
    for (int k = threadIdx.x; k <= m; k += blockDim.x) {
      br[k] = xr[off + k];
      bi[k] = xi[off + k];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const float a = br[k], c = br[m - k];
      const float b = k == 0 ? 0.f : bi[k];      // Im X[0] dropped
      const float d = k == 0 ? 0.f : bi[m - k];  // Im X[m] dropped
      const float er = 0.5f * (a + c), ei = 0.5f * (b - d);  // E[k]
      const float dr = 0.5f * (a - c), di = 0.5f * (b + d);
      const float cr = vr[k], ci = vi[k];
      const float orr = dr * cr - di * ci, oi = dr * ci + di * cr;  // O[k]
      ar[k] = er - oi;
      ai[k] = ei + orr;
    }
    __syncthreads();
    run_stages(ar, ai, br, bi, sched, 1, 1, zr, zi, SmemMap{m, 1});
    __syncthreads();
    float2* yrow = reinterpret_cast<float2*>(y + static_cast<int64_t>(row) * n);
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      yrow[j] = make_float2(2.f * zr[j], 2.f * zi[j]);
  }
}

}  // namespace

// Both entry points act on the caller's current device; the caller sets it.

// The most dynamic shared memory any valid schedule asks for, at m = 2048:
// stage tables of at most 2*256 + 2*2048 + 2*256 floats, the v table of
// 2*2049 floats and four planes of 2049 floats (69656 bytes).
constexpr int kMaxSmem = static_cast<int>(sizeof(float)) *
                         (2 * 256 + 2 * 2048 + 2 * 256 + 2 * 2049 + 4 * 2049);

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device and report how many blocks of `smem` bytes fit on one SM.  Returns
// the CUDA error code, 0 on success.
extern "C" int c2r_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      c2r_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, c2r_kernel, kThreads, static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream`.  Returns the CUDA error code of the
// launch, 0 on success.  The caller checks shapes: rows >= 1, n even with
// m = n/2 = p0 or p0 * p1, m <= 2048, radices <= 256, y 8-byte aligned,
// tab_len = stage tables + 2 * (m + 1), and smem = 4 * (tab_len + 4 * (m + 1))
// bytes, allowed by c2r_occupancy.
extern "C" int c2r_launch(const float* xr, const float* xi, float* y,
                          const float* tab, int tab_len, int rows, int n,
                          int nstages, int p0, int p1, int grid, int smem,
                          void* stream) {
  c2r_kernel<<<grid, kThreads, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(xr, xi, y, tab, tab_len,
                                                    rows, n, nstages, p0, p1);
  return static_cast<int>(cudaGetLastError());
}
