// Batched 1-D complex-to-real FFT along the last axis: split f32 planes
// (B, n/2+1) -> real f32 rows (B, n), n even, the unnormalized inverse of
// r2c.cu (c2r(r2c(x)) = n x).  Hand-written for Hopper (sm_90a).
//
// Replaces the fused c2r Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_c2r, reached through
// _make_call_c2r.  The reference runs two m-point inverse transforms
// (m = n/2) of X[0..m-1] and v^k X[0..m-1] and needs no index reversal,
// which Mosaic lacks.  Here the tangle reads X[k] and X[m-k] straight from
// device memory, so the kernel takes the c2r pack of the reference's
// c2r_pack solver (fftw3_tpu/ops/real.py) instead: K4 (r2c.cu) run
// backwards,
//   E[k] = (X[k] + conj X[m-k]) / 2,  O[k] = (X[k] - conj X[m-k]) v[k] / 2,
//   Z[k] = E[k] + i O[k],  k = 0..m-1,  v[k] = exp(+2*pi*i*k/n),
// ONE complex inverse m-point transform z = T+(Z), and y[2j] = 2 Re z[j],
// y[2j+1] = 2 Im z[j].  Im X[0] and Im X[m] are dropped first, as numpy,
// FFTW and the reference's kernel drop them.  v comes from the host in f64,
// cast to f32.  The halves of E and O and the 2 of the store are powers of
// two, so the kernel forms 2Z and stores z as it comes: the same numbers,
// barring overflow or underflow.
//
// What bounds it on an H100: the data moves once, 8 bytes read per input
// bin and 4 bytes written per real point, against 3.35 TB/s of HBM: 0.160
// ms at (65536, 1024), 0.080 ms at (16384, 2048) on an H100 80GB HBM3.  The
// m-point transform runs as K1 runs its rows, not as the dense p-term sum:
// the host's level plan for rows (stockham.level_plan(m, radices)), each
// 2-3-5-smooth stage as the register butterfly levels of stockham_bfly.cuh
// (a radix with a prime factor of 7 or more keeps the dense sum), on groups
// of rpb whole rows (rpb * m <= 2048 points, stockham.rows_per_block), so
// each barrier serves them all.  Per group: the tangle, one thread a pair
// (k, m-k) of a row, reads X[k] and X[m-k] once each (scalar loads: the
// rows have an odd length, n/2+1 floats, so they are not 8-byte aligned;
// a warp's loads are consecutive both ways) and writes 2Z[k] and 2Z[m-k]
// straight into the level buffer; one barrier; the levels, in place; the
// last one stores point o of a row as the float2 (y[2o], y[2o+1]) through
// an interleaved map: its stores are k1*done + d, consecutive across a
// warp wherever done >= 32 (every m >= 512), 256 bytes a warp.  No staging
// buffer and no Z region: two barriers a group besides the levels'.
//
// Blocks walk the groups with a grid stride; any batch works with no
// padding; row offsets are 64-bit.  256 threads of up to 8 points in a
// level, 128 registers a thread, two blocks per SM, as K4.

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

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;
// points a thread holds in one level: groups of 2048 points
constexpr int kPts = 8;
constexpr int kGroupPoints = kPts * kThreads;
// a cap on any plan's shared memory (tables and the buffers), set once
constexpr int kMaxSmem = 98304;

// The last level's store: point o of row `row` of the group as the float2
// (y[2o], y[2o+1]) of that row.
struct PairMap {
  static constexpr bool kInterleaved = true;
  int m;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int operator()(int row, int o, int) const {
    return row * m + o;
  }
};

// Shared-memory bytes of a launch (the wrapper computes the same): the
// m-point tables and the v table, then nbuf level buffers of two planes of
// rpb rows at stride rs.
inline int c2r_smem(const LevelPlan& plan, int m, int rpb) {
  const int plane = (rpb * plan.rs + 3) & ~3;
  return static_cast<int>(sizeof(float)) *
         (((plan.tab_len + 2 * (m + 1) + 3) & ~3) + 2 * plan.nbuf * plane);
}

// tab: the m-point tables of sign +1 (stockham.kernel_table layout,
// plan.tab_len floats) followed by re(v[0..m]) and im(v[0..m]).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
c2r_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           float* __restrict__ y, const float* __restrict__ tab,
           const LevelPlan plan, int rows, int n, int rpb) {
  extern __shared__ float4 smem4[];
  __shared__ Level lev[kMaxLevels];
  const int m = n / 2;
  const int h = m + 1;  // bins of a half-spectrum row
  const int tab_len = plan.tab_len + 2 * h;
  float* tb = reinterpret_cast<float*>(smem4);
  const int plane = (rpb * plan.rs + 3) & ~3;
  float* ar = tb + ((tab_len + 3) & ~3);
  float* ai = ar + plane;
  float* br = ai + plane;  // second buffer, only with a dense stage
  float* bi = br + plane;
  const float* vr = tb + plan.tab_len;
  const float* vi = vr + h;
  stage_levels(plan, lev);
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const int rs = plan.rs;
  const int pairs = m / 2 + 1;  // (k, m - k) for k = 0..m/2
  const int groups = (rows + rpb - 1) / rpb;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * rpb;
    const int nr = rows - r0 < rpb ? static_cast<int>(rows - r0) : rpb;
    const float* gr = xr + r0 * h;
    const float* gi = xi + r0 * h;
    __syncthreads();  // levels and tables staged; the previous group's
                      // last level has read the buffer
    for (int i = threadIdx.x; i < nr * pairs; i += blockDim.x) {
      const int row = i / pairs;
      const int k = i - row * pairs;
      const int j = m - k;
      const float a = gr[row * h + k], c = gr[row * h + j];
      const float b = k == 0 ? 0.f : gi[row * h + k];  // Im X[0] dropped
      const float d = k == 0 ? 0.f : gi[row * h + j];  // Im X[m] dropped
      float* zr = ar + row * rs;
      float* zi = ai + row * rs;
      {
        // 2E[k] = X[k] + conj X[m-k], 2O[k] = (X[k] - conj X[m-k]) v[k]
        const float er = a + c, ei = b - d, dr = a - c, di = b + d;
        const float cr = vr[k], ci = vi[k];
        zr[k] = er - (dr * ci + di * cr);
        zi[k] = ei + (dr * cr - di * ci);
      }
      if (k != 0 && k != j) {
        // the same with X[m-k] and conj X[k]: Z[m-k]
        const float er = c + a, ei = d - b, dr = c - a, di = d + b;
        const float cr = vr[j], ci = vi[j];
        zr[j] = er - (dr * ci + di * cr);
        zi[j] = ei + (dr * cr - di * ci);
      }
    }
    __syncthreads();
    // point o of row r to (y[2o], y[2o+1]) of row r0 + r
    run_levels<kPts, Arm::kFull>(plan, lev, tb, ar, ai, br, bi, m, 1, nr,
                                 y + r0 * n, nullptr, PairMap{m});
  }
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// Both entry points act on the caller's current device; the caller sets it.

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device (always the same value: the attribute is a cap) and report how many
// blocks of `smem` bytes fit on one SM.  Returns the CUDA error code.
extern "C" int c2r_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      c2r_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, c2r_kernel, kThreads, static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream` on the host's level plan `plan` of the
// m-point transform (stockham.level_plan(n/2, radices)), rpb rows a group.
// Returns the CUDA error code of the launch, 0 on success.  The caller
// checks shapes: rows >= 1, n even, rpb * n/2 <= kGroupPoints, y 8-byte
// aligned, tab holding the plan's tab_len floats and the v table, smem =
// c2r_smem(plan, n/2, rpb), allowed by c2r_occupancy.
extern "C" int c2r_launch(const float* xr, const float* xi, float* y,
                          const float* tab, const int* plan, int rows, int n,
                          int rpb, int grid, int smem, void* stream) {
  LevelPlan p;
  if (!read_plan(plan, 1, &p) || n % 2 || rpb < 1 ||
      rpb * (n / 2) > kGroupPoints || smem != c2r_smem(p, n / 2, rpb))
    return static_cast<int>(cudaErrorInvalidValue);
  c2r_kernel<<<grid, kThreads, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(xr, xi, y, tab, p, rows,
                                                    n, rpb);
  return static_cast<int>(cudaGetLastError());
}
