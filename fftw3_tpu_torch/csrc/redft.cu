// K8: batched 1-D DCT-II and DCT-III along the last axis, FFTW's
// unnormalised REDFT10 and REDFT01, real f32 rows (B, n) -> real f32 rows
// (B, n), n even.  Hand-written for Hopper (sm_90a).
//
// It replaces no Pallas kernel of the reference package.  It fuses K4
// (r2c.cu) or K6 (c2r.cu) with the PyTorch passes of the reference's
// Makhoul reductions, redft10_half and redft01_half
// (fftw3_tpu/ops/r2r.py, ops/r2r.py here): the permutation, the
// quarter-wave twiddle, the flip and the concatenation, each one more read
// and write of the rows around the child kernel, now happen in shared
// memory, so a row is read once and written once.
//
// DCT-II (kDir 0), with m = n/2:
//   v[j] = x[2j], v[n-1-j] = x[2j+1]                   (j < m, Makhoul)
//   z[j] = v[2j] + i v[2j+1], Z = DFT_m(z)             (K4's pack)
//   V[k] = A[k] + w^k B[k], w = exp(-2 pi i / n)       (K4's untangle)
//   y[k] = 2 Re(q^k V[k]),  y[n-k] = -2 Im(q^k V[k]),  q = exp(-i pi / 2n)
// for k = 0..m (y[n-k] for 0 < k < m).  With n % 4 == 0 one float4 of a
// row, x[4t..4t+3], is z[t] = (x[4t], x[4t+2]) and z[m-1-t] = (x[4t+3],
// x[4t+1]): the permutation costs one 16-byte shared-memory read a thread.
// DCT-III (kDir 1), the mirror, K6's structure:
//   X[k] = q^k (y[k] - i y[n-k])  (y[n] := 0; q = exp(+i pi / 2n)): 2V[k]
//   2Z[k] from X[k] and X[m-k]                         (K6's tangle)
//   v = IDFT_m(2Z) as (Re, Im) pairs = c2r(2V)         (K6's levels)
//   x[2j] = v[j], x[2j+1] = v[n-1-j]
// and with n % 4 == 0 the store is one float4 a thread, (z[t].re,
// z[m-1-t].im, z[t].im, z[m-1-t].re).  The halves and doublings of the
// reductions are powers of two and are folded away: the same numbers,
// barring overflow and underflow.  Constants come from the host in f64,
// rounded once to f32: K4's table (DCT-II) or K6's (DCT-III), then
// re(q^k), im(q^k) for k = 0..m.
//
// What bounds it on an H100: bytes, 4 read and 4 written a point (8 B a
// point a pass; 0.32 ms at 512^3 at 3.35 TB/s), against 2.5 n log2 n
// flops a row (0.045 ms at 512^3).  So the kernel keeps the rows' traffic
// to that one read and one write and overlaps the read with the
// arithmetic: a block walks groups of rpb whole rows, and while it runs the
// levels and the stores of one group the copy engine brings the next
// group's rows, one contiguous chunk of rpb * n floats, into a staging
// buffer (cp.async.bulk completing an mbarrier; where the rows are not
// 16-byte aligned, or n % 4 != 0, the threads copy it themselves, in
// order).  Per group: the permutation (DCT-II) or the twiddle and tangle
// (DCT-III) from the staging buffer into the level buffer; the next group's
// copy issued; the m-point levels in place, K1's register butterflies
// (stockham_bfly.cuh), the last storing Z to a Z region; then the untangle
// and twiddle storing y[k] and y[n-k] (two coalesced scalar stores a
// point, one ascending, one descending) or the inverse permutation storing
// float4s.
//
// Two forms: the run-time form takes any level plan, 256 threads of up to 8
// points in a level, groups of stockham.rows_per_block(m) rows (2048
// points); the fixed form (kFixed) runs the plan of m = 256 on [256]
// (bfly 256 = 16 x 16) compiled in, Fixed256 (run_fixed_levels: no plan
// read at run time, no switch on a radix), on groups of 16 rows, 4096
// points, one 16-point butterfly a thread a level.  The host picks the
// fixed form exactly when its plan is Fixed256's (redft.fixed_fits).
//
// Blocks walk the groups with a grid stride; any batch works with no
// padding; row offsets are 64-bit.  Launch bounds of two blocks of 256
// threads an SM: at most 128 registers a thread.

#include "stockham_bfly.cuh"

namespace fftw3_tpu_torch {
namespace {

using fftw3_tpu_torch::Arm;
using fftw3_tpu_torch::FixedLevel;
using fftw3_tpu_torch::Level;
using fftw3_tpu_torch::LevelPlan;
using fftw3_tpu_torch::kMaxLevels;
using fftw3_tpu_torch::read_plan;
using fftw3_tpu_torch::run_fixed_levels;
using fftw3_tpu_torch::run_levels;
using fftw3_tpu_torch::stage_levels;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;
// points a thread holds in one level, by form: groups of 2048 points
// (run-time) and 4096 (fixed)
constexpr int kRunPts = 8, kFixedPts = 16;
// a cap on any plan's shared memory (tables, the level buffers, Z, the
// staging buffer), set once; redft.MAX_SMEM
constexpr int kMaxSmem = 116736;

// The fixed form's plan: stockham.level_plan(256, (256,)) for rows (tl =
// 1), which redft.FIXED_PLAN repeats, on groups of kFixedRows rows.
constexpr int kFixedRows = 16;
struct Fixed256 {
  static constexpr int tl = 1;
  static constexpr int plan[] = {2,  1,  264, 512, 16, 16, 1, 256, 0, 0,
                                 256, 1, 16,  16,  16, 16, 0, 0,   256, 0};
};

// The last level's store: point o of row `row` of the group to Z.
struct ZMap {
  int m;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int operator()(int row, int o, int) const {
    return row * m + o;
  }
};

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// Shared-memory bytes of a launch (redft.redft_smem computes the same): the
// m-point tables, the w table and the q table; nbuf level buffers of two
// planes of rpb rows at stride rs; Z, two planes of rpb rows of m; the
// staging buffer of rpb rows of n.
inline int redft_smem(const LevelPlan& plan, int m, int rpb) {
  return static_cast<int>(sizeof(float)) *
         (up4(plan.tab_len + 4 * (m + 1)) +
          2 * plan.nbuf * up4(rpb * plan.rs) + 2 * up4(rpb * m) +
          up4(rpb * 2 * m));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Brings `count` floats from `src` into the staging buffer `st`.  Bulk:
// thread 0 asks the copy engine for them, which completes the transaction
// count of `bar` (the threads' last reads of `st` were ordered before this
// by a block barrier; the proxy fence orders them before the engine's
// writes); the caller waits with wait_staged.  Else every thread copies its
// share, and the caller's next block barrier makes it visible.
__device__ __forceinline__ void stage_rows(const float* src, int count,
                                           float* st, uint64_t* bar,
                                           bool bulk) {
  if (bulk) {
    if (threadIdx.x != 0) return;
    const uint32_t bytes = static_cast<uint32_t>(count) * sizeof(float);
    const uint32_t b = smem_u32(bar);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(st)), "l"(src), "r"(bytes),
        "r"(b) : "memory");
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) st[i] = src[i];
  }
}

// The staged chunk of group g: rows g * rpb .. of x, contiguous.
__device__ __forceinline__ void stage_group(const float* x, int rows, int n,
                                            int rpb, int g, float* st,
                                            uint64_t* bar, bool bulk) {
  const int64_t r0 = static_cast<int64_t>(g) * rpb;
  const int nr = rows - r0 < rpb ? static_cast<int>(rows - r0) : rpb;
  stage_rows(x + r0 * n, nr * n, st, bar, bulk);
}

// Every thread waits for the phase of `bar` of parity `parity` to
// complete: the staged rows have landed and are visible.
__device__ __forceinline__ void wait_staged(uint64_t* bar, unsigned parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
}

// DCT-II's permutation: the staged rows (row r at st + r * n) to z in the
// level buffer, point j of row r at r * rs + j.
__device__ __forceinline__ void permute_in(const float* st, float* ar,
                                           float* ai, int nr, int n, int rs) {
  const int m = n / 2;
  if (n % 4 == 0) {
    const int quads = m / 2;
    for (int i = threadIdx.x; i < nr * quads; i += blockDim.x) {
      const int row = i / quads;
      const int t = i - row * quads;
      const float4 v = reinterpret_cast<const float4*>(st + row * n)[t];
      float* zr = ar + row * rs;
      float* zi = ai + row * rs;
      zr[t] = v.x;
      zi[t] = v.z;
      zr[m - 1 - t] = v.w;
      zi[m - 1 - t] = v.y;
    }
  } else {
    for (int i = threadIdx.x; i < nr * m; i += blockDim.x) {
      const int row = i / m;
      const int j = i - row * m;
      const float* s = st + row * n;
      // v[a] = x[2a] for a < m, else x[2n - 1 - 2a]
      const int a = 2 * j, b = 2 * j + 1;
      ar[row * rs + j] = s[a < m ? 2 * a : 2 * n - 1 - 2 * a];
      ai[row * rs + j] = s[b < m ? 2 * b : 2 * n - 1 - 2 * b];
    }
  }
}

// DCT-II's untangle and quarter-wave twiddle: Z (row r at r * m) to the
// output rows.  (ur, ui) = 2A[k], (vr, vi) = 2B[k], (sr, si) = 2V[k].
__device__ __forceinline__ void untangle_out(const float* zr, const float* zi,
                                             const float* wr, const float* wi,
                                             const float* qr, const float* qi,
                                             float* y, int nr, int n) {
  const int m = n / 2;
  const int h = m + 1;
  for (int i = threadIdx.x; i < nr * h; i += blockDim.x) {
    const int row = i / h;
    const int k = i - row * h;
    const int k0 = k == m ? 0 : k;      // k mod m
    const int k1 = k == 0 ? 0 : m - k;  // (m - k) mod m
    const float a = zr[row * m + k0], b = zi[row * m + k0];  // Z[k]
    const float c = zr[row * m + k1], d = zi[row * m + k1];  // Z[m-k]
    const float ur = a + c, ui = b - d;
    const float vr = b + d, vi = c - a;
    const float cr = wr[k], ci = wi[k];
    const float sr = ur + cr * vr - ci * vi;
    const float si = ui + cr * vi + ci * vr;
    const float tr = qr[k], ti = qi[k];
    float* yrow = y + static_cast<int64_t>(row) * n;
    yrow[k] = tr * sr - ti * si;
    if (k != 0 && k != m) yrow[n - k] = -(tr * si + ti * sr);
  }
}

// DCT-III's twiddle and tangle: the staged rows to 2Z in the level buffer,
// point k of row r at r * rs + k, one thread a pair (k, m - k).
__device__ __forceinline__ void tangle_in(const float* st, const float* vr,
                                          const float* vi, const float* qr,
                                          const float* qi, float* ar,
                                          float* ai, int nr, int n, int rs) {
  const int m = n / 2;
  const int pairs = m / 2 + 1;  // (k, m - k) for k = 0..m/2
  for (int i = threadIdx.x; i < nr * pairs; i += blockDim.x) {
    const int row = i / pairs;
    const int k = i - row * pairs;
    const int j = m - k;
    const float* s = st + row * n;
    // X[k] = q^k (y[k] - i y[n-k]), y[n] := 0; Im X[0], Im X[m] dropped
    const float yk = s[k], ynk = k == 0 ? 0.f : s[n - k];
    const float yj = s[j], ynj = s[n - j];
    const float a = qr[k] * yk + qi[k] * ynk;
    const float b = k == 0 ? 0.f : qi[k] * yk - qr[k] * ynk;
    const float c = qr[j] * yj + qi[j] * ynj;
    const float d = k == 0 ? 0.f : qi[j] * yj - qr[j] * ynj;
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
}

// DCT-III's inverse permutation: z (row r at r * m of Z; v[2o] = Re z[o],
// v[2o+1] = Im z[o]) to the output rows, x[2j] = v[j], x[2j+1] = v[n-1-j].
__device__ __forceinline__ void permute_out(const float* zr, const float* zi,
                                            float* y, int nr, int n) {
  const int m = n / 2;
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0) {
    const int quads = m / 2;
    for (int i = threadIdx.x; i < nr * quads; i += blockDim.x) {
      const int row = i / quads;
      const int t = i - row * quads;
      const float* r = zr + row * m;
      const float* im = zi + row * m;
      reinterpret_cast<float4*>(y + static_cast<int64_t>(row) * n)[t] =
          make_float4(r[t], im[m - 1 - t], im[t], r[m - 1 - t]);
    }
  } else {
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
      const int row = i / n;
      const int p = i - row * n;
      const int a = p % 2 == 0 ? p / 2 : n - 1 - p / 2;  // x[p] = v[a]
      const float* z = a % 2 == 0 ? zr : zi;
      y[static_cast<int64_t>(row) * n + p] = z[row * m + a / 2];
    }
  }
}

// tab: the m-point tables of the direction's sign (stockham.kernel_table
// layout, plan.tab_len floats), re and im of w^k (DCT-II) or v^k (DCT-III),
// k = 0..m, then re and im of q^k, k = 0..m.  kFixed: `plan` is Fixed256's.
template <int kDir, bool kFixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
redft_kernel(const float* __restrict__ x, float* __restrict__ y,
             const float* __restrict__ tab, const LevelPlan plan, int rows,
             int n, int rpb) {
  extern __shared__ float4 smem4[];
  __shared__ Level lev[kMaxLevels];
  __shared__ uint64_t bar;
  const int m = n / 2;
  const int h = m + 1;
  const int tab_len = plan.tab_len + 4 * h;
  float* tb = reinterpret_cast<float*>(smem4);
  const int plane = up4(rpb * plan.rs);
  float* ar = tb + up4(tab_len);
  float* ai = ar + plane;
  float* br = ai + plane;  // second buffer, only with a dense stage
  float* bi = br + plane;
  float* zr = ar + 2 * plan.nbuf * plane;
  float* zi = zr + up4(rpb * m);
  float* st = zi + up4(rpb * m);
  const float* wr = tb + plan.tab_len;
  const float* wi = wr + h;
  const float* qr = wi + h;
  const float* qi = qr + h;
  if (!kFixed) stage_levels(plan, lev);
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const bool bulk = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (bulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int groups = (rows + rpb - 1) / rpb;
  if (blockIdx.x < groups) stage_group(x, rows, n, rpb, blockIdx.x, st, &bar,
                                       bulk);
  unsigned parity = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * rpb;
    const int nr = rows - r0 < rpb ? static_cast<int>(rows - r0) : rpb;
    if (bulk) {
      wait_staged(&bar, parity);
      parity ^= 1;
    }
    __syncthreads();  // the rows are staged; the previous group's last
                      // reads of Z are done
    if (kDir == 0)
      permute_in(st, ar, ai, nr, n, plan.rs);
    else
      tangle_in(st, wr, wi, qr, qi, ar, ai, nr, n, plan.rs);
    __syncthreads();  // the staging buffer is free
    const int next = g + static_cast<int>(gridDim.x);
    if (next < groups) stage_group(x, rows, n, rpb, next, st, &bar, bulk);
    if constexpr (kFixed) {
      run_fixed_levels<kFixedPts, Fixed256, Arm::kFull>(
          tb, ar, ai, FixedLevel<Fixed256, 0>::rs, Fixed256::tl, ar, ai, nr,
          zr, zi, ZMap{m});
    } else {
      run_levels<kRunPts, Arm::kFull>(plan, lev, tb, ar, ai, br, bi, m, 1,
                                      nr, zr, zi, ZMap{m});
    }
    __syncthreads();
    if (kDir == 0)
      untangle_out(zr, zi, wr, wi, qr, qi, y + r0 * n, nr, n);
    else
      permute_out(zr, zi, y + r0 * n, nr, n);
  }
}

template <class P>
bool is_plan(const int* p) {
  for (size_t i = 0; i < sizeof(P::plan) / sizeof(int); ++i)
    if (p[i] != P::plan[i]) return false;
  return true;
}

using Kernel = void (*)(const float*, float*, const float*, const LevelPlan,
                        int, int, int);

Kernel kernel_of(int dir, bool fixed) {
  if (dir == 0)
    return fixed ? redft_kernel<0, true> : redft_kernel<0, false>;
  return fixed ? redft_kernel<1, true> : redft_kernel<1, false>;
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// Both entry points act on the caller's current device; the caller sets it.

// Allow every form kMaxSmem bytes of dynamic shared memory on the current
// device (always the same value: the attribute is a cap) and report how many
// blocks of `smem` bytes fit on one SM (the forms share their block size and
// launch bounds).  Returns the CUDA error code.
extern "C" int redft_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  for (int dir = 0; dir < 2; ++dir)
    for (int fixed = 0; fixed < 2; ++fixed) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel_of(dir, fixed), cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel_of(0, false), kThreads,
      static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream`: DCT-II (dir 0) or DCT-III (dir 1) of
// `rows` rows of n, on the host's level plan `plan` of the m-point
// transform (stockham.level_plan(n/2, radices)), rpb rows a group, the
// fixed form where `fixed`.  Returns the CUDA error code of the launch, 0 on
// success.  The caller checks shapes: rows >= 1, n even, x and y rows of n
// floats, tab holding the plan's tab_len floats, the w or v table and the q
// table, smem = redft_smem(plan, n/2, rpb), allowed by redft_occupancy.
extern "C" int redft_launch(const float* x, float* y, const float* tab,
                            const int* plan, int rows, int n, int rpb,
                            int dir, int fixed, int grid, int smem,
                            void* stream) {
  LevelPlan p;
  const int pts = fixed ? kFixedPts : kRunPts;
  if (!read_plan(plan, 1, &p) || n % 2 || rpb < 1 ||
      rpb * (n / 2) > pts * kThreads || (dir != 0 && dir != 1) ||
      smem != redft_smem(p, n / 2, rpb) ||
      (fixed && (n != 512 || rpb != kFixedRows || !is_plan<Fixed256>(plan))))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel_of(dir, fixed)<<<grid, kThreads, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      x, y, tab, p, rows, n, rpb);
  return static_cast<int>(cudaGetLastError());
}
