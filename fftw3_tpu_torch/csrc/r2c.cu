// Batched 1-D real-to-complex FFT along the last axis: real f32 rows (B, n)
// -> split f32 planes (B, n/2+1), n even.  Hand-written for Hopper (sm_90a).
//
// Replaces the fused r2c Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_r2c, reached through
// _make_call_r2c.  Unnormalized, FFTW's rdft2 layout: X[k] for k = 0..n/2.
//
// The reference runs two real-input m-point transforms (m = n/2), A over the
// even samples and B over the odd ones, and forms X[k] = A[k] + w^k B[k]
// with A[m] := A[0]; it avoids any index reversal because Mosaic has none.
// Here shared memory reverses for free, so the kernel takes the rdft2 pack
// instead (the algebra of the reference's own r2c_pack solver,
// fftw3_tpu/ops/real.py): z[j] = x[2j] + i x[2j+1], ONE complex m-point
// transform Z = DFT_m(z) through the shared stage loop (stockham_stage.cuh),
// then the untangle
//   A[k] = (Z[k] + conj Z[m-k]) / 2,   B[k] = -i (Z[k] - conj Z[m-k]) / 2,
//   X[k] = A[k] + w[k] B[k],           k = 0..m, indices of Z taken mod m,
// with w[k] = exp(-2*pi*i*k/n) computed on the host in f64 and cast to f32
// (the reference's constant).  That is half the dense p-term sum of the
// two-transform form.
//
// What bounds it on an H100: the data moves once, 4 bytes read per real
// point and 8 bytes written per output bin (about 8 bytes per real point in
// all) against 3.35 TB/s of HBM; the arithmetic is the dense p-term complex
// sum of the m-point transform, which, as in the c2c kernel, is what the
// card spends its time on.  The design keeps HBM at one read and one write:
// a block holds whole rows in shared memory through the load (one 8-byte
// float2 per thread and sample pair: the even/odd split costs nothing), the
// stages and the untangle.  The output rows have an odd length (n/2+1
// floats), so their starts are not 16-byte aligned: the untangle stores
// scalars, coalesced.
//
// Blocks walk rows with a grid stride; any batch works with no padding; row
// offsets are 64-bit.

#include "stockham_stage.cuh"

namespace {

using fftw3_tpu_torch::run_stages;
using fftw3_tpu_torch::Schedule;
using fftw3_tpu_torch::SmemMap;

constexpr int kThreads = 256;

// tab: the m-point stage tables (stockham_stage.cuh layout) followed by
// re(w[0..m]) and im(w[0..m]); tab_len counts both.
__global__ void __launch_bounds__(kThreads)
r2c_kernel(const float* __restrict__ x, float* __restrict__ yr,
           float* __restrict__ yi, const float* __restrict__ tab, int tab_len,
           int rows, int n, int nstages, int p0, int p1) {
  extern __shared__ float smem[];
  const int m = n / 2;
  float* tb = smem;
  float* ar = smem + tab_len;
  float* ai = ar + m;
  float* br = ai + m;
  float* bi = br + m;

  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const Schedule sched(tb, m, nstages, p0, p1);
  const float* wr = tb + tab_len - 2 * (m + 1);
  const float* wi = wr + (m + 1);
  // the last stage writes Z here: after one stage (ar -> br), after two
  // (ar -> br -> ar)
  float* zr = nstages == 1 ? br : ar;
  float* zi = nstages == 1 ? bi : ai;

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const float2* xrow =
        reinterpret_cast<const float2*>(x + static_cast<int64_t>(row) * n);
    __syncthreads();  // tables staged; previous row's readers are done
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const float2 v = xrow[j];  // (x[2j], x[2j+1])
      ar[j] = v.x;
      ai[j] = v.y;
    }
    __syncthreads();
    run_stages(ar, ai, br, bi, sched, 1, 1, zr, zi, SmemMap{m, 1});
    __syncthreads();
    const int64_t off = static_cast<int64_t>(row) * (m + 1);
    for (int k = threadIdx.x; k <= m; k += blockDim.x) {
      const int k0 = k == m ? 0 : k;      // k mod m
      const int k1 = k == 0 ? 0 : m - k;  // (m - k) mod m
      const float a = zr[k0], b = zi[k0];  // Z[k]
      const float c = zr[k1], d = zi[k1];  // Z[m-k]
      const float ur = 0.5f * (a + c), ui = 0.5f * (b - d);  // A[k]
      const float vr = 0.5f * (b + d), vi = 0.5f * (c - a);  // B[k]
      const float cr = wr[k], ci = wi[k];
      yr[off + k] = ur + cr * vr - ci * vi;
      yi[off + k] = ui + cr * vi + ci * vr;
    }
  }
}

}  // namespace

// Both entry points act on the caller's current device; the caller sets it.

// The most dynamic shared memory any valid schedule asks for, at m = 2048:
// stage tables of at most 2*256 + 2*2048 + 2*256 floats, the w table of
// 2*2049 floats and four planes of 2048 floats (69640 bytes).
constexpr int kMaxSmem = static_cast<int>(sizeof(float)) *
                         (2 * 256 + 2 * 2048 + 2 * 256 + 2 * 2049 + 4 * 2048);

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device (always the same value: the attribute is a cap) and report how many
// blocks of `smem` bytes fit on one SM.  Returns the CUDA error code.
extern "C" int r2c_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      r2c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, r2c_kernel, kThreads, static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream`.  Returns the CUDA error code of the
// launch, 0 on success.  The caller checks shapes: rows >= 1, n even with
// m = n/2 = p0 (one stage) or p0 * p1 (two stages), m <= 2048, radices <= 256,
// x 8-byte aligned, tab_len = stage tables + 2 * (m + 1), and
// smem = 4 * (tab_len + 4 * m) bytes, allowed by r2c_occupancy.
extern "C" int r2c_launch(const float* x, float* yr, float* yi,
                          const float* tab, int tab_len, int rows, int n,
                          int nstages, int p0, int p1, int grid, int smem,
                          void* stream) {
  r2c_kernel<<<grid, kThreads, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(x, yr, yi, tab, tab_len,
                                                    rows, n, nstages, p0, p1);
  return static_cast<int>(cudaGetLastError());
}
