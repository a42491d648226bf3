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
// transform Z = DFT_m(z), then the untangle
//   A[k] = (Z[k] + conj Z[m-k]) / 2,   B[k] = -i (Z[k] - conj Z[m-k]) / 2,
//   X[k] = A[k] + w[k] B[k],           k = 0..m, indices of Z taken mod m,
// with w[k] = exp(-2*pi*i*k/n) computed on the host in f64 and cast to f32
// (the reference's constant).
//
// What bounds it on an H100: the data moves once, 4 bytes read per real
// point and 8 bytes written per output bin (about 8 bytes per real point in
// all) against 3.35 TB/s of HBM.  The m-point transform runs as K1 runs
// its rows, not as the dense p-term sum: the host's level plan for rows
// (stockham.level_plan(m, radices)), each 2-3-5-smooth stage as the
// register butterfly levels of stockham_bfly.cuh (a radix with a prime
// factor of 7 or more keeps the dense sum), on groups of rpb whole rows
// (rpb * m <= 2048 points, stockham.rows_per_block), so each barrier serves
// them all.  Per group: the first level, when it is a butterfly level,
// reads z straight from the input rows (re at x + 2j, im at x + 2j + 1: the
// even/odd split costs nothing), as K1 reads its rows; a dense first stage
// reads a buffer the group's float2 loads fill first.  Then the levels, in
// place, the last one storing Z through a map into an unpadded Z region of
// shared memory (row r at r*m: its stores are k1*done + d, consecutive
// across a warp, and the untangle reads k and m - k, consecutive both ways:
// no bank conflicts); then the untangle, whose output rows have an odd
// length (n/2+1 floats), so they are not 16-byte aligned: it stores
// scalars, coalesced, the group's rows contiguous.
//
// Blocks walk the groups with a grid stride; any batch works with no
// padding; row offsets are 64-bit.  256 threads of up to 8 points in a
// level, 128 registers a thread, two blocks per SM, as K1.

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
// a cap on any plan's shared memory (tables, the buffers, Z), set once
constexpr int kMaxSmem = 98304;

// The last level's store: point o of row `row` of the group to Z.
struct ZMap {
  int m;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int operator()(int row, int o, int) const {
    return row * m + o;
  }
};

// Shared-memory bytes of a launch (the wrapper computes the same): the
// m-point tables and the w table, nbuf level buffers of two planes of rpb
// rows at stride rs, and Z, two planes of rpb rows of m.
inline int r2c_smem(const LevelPlan& plan, int m, int rpb) {
  const int plane = (rpb * plan.rs + 3) & ~3;
  const int zplane = (rpb * m + 3) & ~3;
  return static_cast<int>(sizeof(float)) *
         (((plan.tab_len + 2 * (m + 1) + 3) & ~3) + 2 * plan.nbuf * plane +
          2 * zplane);
}

// tab: the m-point tables (stockham.kernel_table layout, plan.tab_len
// floats) followed by re(w[0..m]) and im(w[0..m]).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
r2c_kernel(const float* __restrict__ x, float* __restrict__ yr,
           float* __restrict__ yi, const float* __restrict__ tab,
           const LevelPlan plan, int rows, int n, int rpb) {
  extern __shared__ float4 smem4[];
  __shared__ Level lev[kMaxLevels];
  const int m = n / 2;
  const int tab_len = plan.tab_len + 2 * (m + 1);
  float* tb = reinterpret_cast<float*>(smem4);
  const int plane = (rpb * plan.rs + 3) & ~3;
  float* ar = tb + ((tab_len + 3) & ~3);
  float* ai = ar + plane;
  float* br = ai + plane;  // second buffer, only with a dense stage
  float* bi = br + plane;
  float* zr = ar + 2 * plan.nbuf * plane;
  float* zi = zr + ((rpb * m + 3) & ~3);
  const float* wr = tb + plan.tab_len;
  const float* wi = wr + (m + 1);
  stage_levels(plan, lev);
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const int rs = plan.rs;
  const bool direct = plan.lev[0].kind != 0;
  const int groups = (rows + rpb - 1) / rpb;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * rpb;
    const int nr = rows - r0 < rpb ? static_cast<int>(rows - r0) : rpb;
    const float2* xs = reinterpret_cast<const float2*>(x + r0 * n);
    __syncthreads();  // levels and tables staged; the previous group's
                      // untangle is done
    if (!direct) {
      for (int i = threadIdx.x; i < nr * m; i += blockDim.x) {
        const int row = i / m;
        const int j = i - row * m;
        const float2 v = xs[i];  // (x[2j], x[2j+1]) of row r0 + row
        ar[row * rs + j] = v.x;
        ai[row * rs + j] = v.y;
      }
      __syncthreads();
    }
    // point j of row r at x[r * n + 2j] (re) and x[r * n + 2j + 1] (im)
    run_levels<kPts, Arm::kFull>(plan, lev, tb, ar, ai, br, bi, m, 1, nr, zr,
                                 zi, ZMap{m}, direct ? x + r0 * n : nullptr,
                                 direct ? x + r0 * n + 1 : nullptr, n, 2);
    __syncthreads();
    const int h = m + 1;
    float* orow_r = yr + r0 * h;
    float* orow_i = yi + r0 * h;
    for (int i = threadIdx.x; i < nr * h; i += blockDim.x) {
      const int row = i / h;
      const int k = i - row * h;
      const int k0 = k == m ? 0 : k;      // k mod m
      const int k1 = k == 0 ? 0 : m - k;  // (m - k) mod m
      const float a = zr[row * m + k0], b = zi[row * m + k0];  // Z[k]
      const float c = zr[row * m + k1], d = zi[row * m + k1];  // Z[m-k]
      const float ur = 0.5f * (a + c), ui = 0.5f * (b - d);    // A[k]
      const float vr = 0.5f * (b + d), vi = 0.5f * (c - a);    // B[k]
      const float cr = wr[k], ci = wi[k];
      orow_r[i] = ur + cr * vr - ci * vi;
      orow_i[i] = ui + cr * vi + ci * vr;
    }
  }
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// Both entry points act on the caller's current device; the caller sets it.

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

// Launch `grid` blocks on `stream` on the host's level plan `plan` of the
// m-point transform (stockham.level_plan(n/2, radices)), rpb rows a group.
// Returns the CUDA error code of the launch, 0 on success.  The caller
// checks shapes: rows >= 1, n even, rpb * n/2 <= kGroupPoints, x 8-byte
// aligned, tab holding the plan's tab_len floats and the w table, smem =
// r2c_smem(plan, n/2, rpb), allowed by r2c_occupancy.
extern "C" int r2c_launch(const float* x, float* yr, float* yi,
                          const float* tab, const int* plan, int rows, int n,
                          int rpb, int grid, int smem, void* stream) {
  LevelPlan p;
  if (!read_plan(plan, 1, &p) || n % 2 || rpb < 1 ||
      rpb * (n / 2) > kGroupPoints || smem != r2c_smem(p, n / 2, rpb))
    return static_cast<int>(cudaErrorInvalidValue);
  r2c_kernel<<<grid, kThreads, static_cast<size_t>(smem),
               static_cast<cudaStream_t>(stream)>>>(x, yr, yi, tab, p, rows,
                                                    n, rpb);
  return static_cast<int>(cudaGetLastError());
}
