// The stage ablation of K1 (E5): timing-only variants of the last-axis
// kernel with one op class removed at a time.  Hand-written for Hopper
// (sm_90a).  Nothing on a user's path reaches these entry points.
//
// Replaces the TPU measurement script experiments/ablate_stage.py
// (make_variant, called at :142), which costs the reference's stage
// pipeline one op class at a time.  Here the arms are
//   0 full         the kernel as it is;
//   1 no twiddle   the inter-stage twiddle multiply (and its table loads)
//                  dropped;
//   2 const roots  every root-table load of the stage arithmetic replaced
//                  by a constant (the dense form's F_p entries, the
//                  butterfly form's in-register constants);
//   3 no stage     the rows are loaded into shared memory and stored back
//                  with no stage at all: the copy floor of the layout;
// for two forms:
//  * dense: K1 as it was first built, one row per block, every stage the dense
//    p-term sum of stockham_stage.cuh (rebuilt here with the arm switches);
//  * bfly: the K1 of stockham_c2c.cu (stockham_rows.cuh) with its register
//    butterfly stages (stockham_bfly.cuh).
// Arms 1-3 compute wrong numbers on purpose.

#include <initializer_list>

#include "stockham_rows.cuh"
#include "stockham_stage.cuh"

namespace fftw3_tpu_torch {
namespace {

using fftw3_tpu_torch::Arm;
using fftw3_tpu_torch::Schedule;
using fftw3_tpu_torch::SmemMap;

constexpr int kDenseThreads = 256;

// The dense form's last-stage store: point o of the row at the pointer.
struct OwnRow {
  __device__ __forceinline__ int operator()(int, int o, int) const {
    return o;
  }
};

// stage() of stockham_stage.cuh for one row (tl = 1, rows = 1), with the
// arm switches.
template <int kArm, class Map>
__device__ __forceinline__ void dense_stage(
    const float* __restrict__ sr, const float* __restrict__ si,
    float* __restrict__ dr, float* __restrict__ di, const Map& map,
    const float* __restrict__ rootr, const float* __restrict__ rooti,
    const float* __restrict__ twr, const float* __restrict__ twi, int n, int p,
    int q, int done, int rest) {
  const int qd = q * done;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int k1 = t / qd;
    const int jd = t - k1 * qd;
    const float* xr = sr + jd;
    const float* xi = si + jd;
    float ar = 0.f, ai = 0.f;
    int e = 0;
#pragma unroll 4
    for (int j1 = 0; j1 < p; ++j1) {
      const float vr = xr[j1 * qd];
      const float vi = xi[j1 * qd];
      float fr, fi;
      if (kArm == Arm::kConstRoots) {
        fr = 0.70710678f;
        fi = -0.70710678f;
      } else {
        fr = rootr[e];
        fi = rooti[e];
      }
      ar = fmaf(fr, vr, ar);
      ar = fmaf(-fi, vi, ar);
      ai = fmaf(fi, vr, ai);
      ai = fmaf(fr, vi, ai);
      e += k1;
      if (e >= p) e -= p;
    }
    const int j2 = jd / done;
    const int d = jd - j2 * done;
    if (q > 1 && kArm != Arm::kNoTwiddle) {
      const int ew = (k1 * j2) % rest;
      const float wr = twr[ew];
      const float wi = twi[ew];
      const float tr = ar * wr - ai * wi;
      ai = ar * wi + ai * wr;
      ar = tr;
    }
    const auto k = map(0, (j2 * p + k1) * done + d, 0);
    dr[k] = ar;
    di[k] = ai;
  }
}

template <int kArm>
__global__ void __launch_bounds__(kDenseThreads)
dense_k1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float* __restrict__ tab, int tab_len, int rows, int n,
                int nstages, int p0, int p1) {
  extern __shared__ float smem[];
  float* tb = smem;
  float* ar = smem + tab_len;
  float* ai = ar + n;
  float* br = ai + n;
  float* bi = br + n;
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb[i] = tab[i];
  const Schedule s(tb, n, nstages, p0, p1);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t off = static_cast<int64_t>(row) * n;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      ar[i] = xr[off + i];
      ai[i] = xi[off + i];
    }
    __syncthreads();
    if (kArm == Arm::kNoStage) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        yr[off + i] = ar[i];
        yi[off + i] = ai[i];
      }
    } else if (s.nstages == 1) {
      dense_stage<kArm>(ar, ai, yr + off, yi + off, OwnRow{}, s.r0r, s.r0i,
                        nullptr, nullptr, n, s.p0, 1, 1, n);
    } else {
      dense_stage<kArm>(ar, ai, br, bi, SmemMap{n, 1}, s.r0r, s.r0i, s.t0r,
                        s.t0i, n, s.p0, s.q0, 1, n);
      __syncthreads();
      dense_stage<kArm>(br, bi, yr + off, yi + off, OwnRow{}, s.r1r, s.r1i,
                        nullptr, nullptr, n, s.p1, 1, s.p0, s.q0);
    }
  }
}

using DenseFn = void (*)(const float*, const float*, float*, float*,
                         const float*, int, int, int, int, int, int);
constexpr DenseFn kDense[4] = {dense_k1_kernel<0>, dense_k1_kernel<1>,
                               dense_k1_kernel<2>, dense_k1_kernel<3>};

// as stockham_c2c.cu's kMaxSmem: the dense form's largest schedule
constexpr int kDenseMaxSmem =
    static_cast<int>(sizeof(float)) * (2 * 256 + 2 * 2048 + 2 * 256 + 4 * 2048);

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// The dense form.  Same contract as the dense K1's stockham_c2c_occupancy /
// stockham_c2c_launch (plain form only), plus the arm (0-3).
extern "C" int ablate_dense_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kDenseMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  for (auto fn : kDense) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kDenseMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kDense[0], kDenseThreads, static_cast<size_t>(smem)));
}

extern "C" int ablate_dense_launch(const float* xr, const float* xi,
                                   float* yr, float* yi, const float* tab,
                                   int tab_len, int rows, int n, int nstages,
                                   int p0, int p1, int arm, int grid,
                                   int smem, void* stream) {
  if (arm < 0 || arm > 3) return static_cast<int>(cudaErrorInvalidValue);
  kDense[arm]<<<grid, kDenseThreads, static_cast<size_t>(smem),
                static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, tab, tab_len, rows, n, nstages, p0, p1);
  return static_cast<int>(cudaGetLastError());
}

// The butterfly form: the K1 of stockham_c2c.cu with the arm as a template
// argument.  Same arguments as stockham_c2c_launch's plain form.
extern "C" int ablate_bfly_occupancy(int smem, int* blocks_per_sm) {
  using fftw3_tpu_torch::rows_occupancy;
  for (int err : {rows_occupancy<Arm::kNoTwiddle>(smem, blocks_per_sm),
                  rows_occupancy<Arm::kConstRoots>(smem, blocks_per_sm),
                  rows_occupancy<Arm::kNoStage>(smem, blocks_per_sm)})
    if (err != 0) return err;
  return rows_occupancy<Arm::kFull>(smem, blocks_per_sm);
}

extern "C" int ablate_bfly_launch(const float* xr, const float* xi,
                                  float* yr, float* yi, const float* tab,
                                  const int* plan, int rows, int n, int rpb,
                                  int arm, int grid, int smem, void* stream) {
  using fftw3_tpu_torch::rows_launch;
  auto s = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case 0: return rows_launch<Arm::kFull>(
        xr, xi, yr, yi, tab, plan, rows, n, rpb, nullptr, 0, 0, grid, smem,
        s);
    case 1: return rows_launch<Arm::kNoTwiddle>(
        xr, xi, yr, yi, tab, plan, rows, n, rpb, nullptr, 0, 0, grid, smem,
        s);
    case 2: return rows_launch<Arm::kConstRoots>(
        xr, xi, yr, yi, tab, plan, rows, n, rpb, nullptr, 0, 0, grid, smem,
        s);
    case 3: return rows_launch<Arm::kNoStage>(
        xr, xi, yr, yi, tab, plan, rows, n, rpb, nullptr, 0, 0, grid, smem,
        s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
