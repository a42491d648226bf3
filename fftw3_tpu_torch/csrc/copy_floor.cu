// E8, the copy floors of K2 and K1: timing-only kernels that move split f32
// planes through shared memory in a kernel's own geometry and do no
// transform.  Hand-written for Hopper (sm_90a).  Nothing on a user's path
// reaches these entry points.
//
// Replaces the TPU measurement script experiments/copy_inner.py
// (make_inner, call at :38; make_lastaxis, call at :69), which races
// copy-only kernels in the axis -2 layout, (1, n, tl) blocks of a
// (pre, n, L) array, against the last-axis layout at matched points.  Both
// arms here compute y = 1.0001 * x, as the reference's do:
//  * inner: K2's geometry (inner_c2c.cu): 512 threads, a block takes
//    groups of gp planes of one (n, tl) tile each (tl consecutive columns),
//    loads them into shared memory as K2 does (16-byte loads when the tile
//    is full and aligned, else 4-byte, the edge tile masked), synchronises
//    and stores every point as K2's last level does: 4-byte stores, tl
//    consecutive floats of a row across a warp, columns past L not stored;
//  * rows: K1's geometry (stockham_rows.cuh): 256 threads, groups of rpb
//    whole rows of n points, 16-byte loads into shared memory when n % 4 ==
//    0, then 4-byte stores, consecutive across a warp.
// What bounds them on an H100: 16 bytes of HBM traffic per point, the
// bound of the kernels whose floor they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace fftw3_tpu_torch {
namespace {

constexpr int kInnerThreads = 512;
constexpr int kRowThreads = 256;
// a cap on either arm's shared memory, set once
constexpr int kMaxSmem = 98304;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kInnerThreads, 1)
copy_inner_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* __restrict__ yr, float* __restrict__ yi, int pre,
                  int n, int64_t L, int tl, int gp) {
  extern __shared__ float4 smem4[];
  float* ar = reinterpret_cast<float*>(smem4);
  const int per = n * tl;
  float* ai = ar + gp * per;
  const int64_t npl = static_cast<int64_t>(n) * L;
  const bool vec = tl % 4 == 0 && L % 4 == 0 && aligned16(xr) &&
                   aligned16(xi);
  const int tsh = __ffs(tl) - 1;
  const int64_t ntiles = (L + tl - 1) / tl;
  const int64_t nblocks = ntiles * ((pre + gp - 1) / gp);
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int64_t g = blk / ntiles;
    const int64_t l0 = (blk - g * ntiles) * tl;
    const int64_t b0 = g * gp;
    const int nr = static_cast<int>(pre - b0 < gp ? pre - b0 : gp);
    const int width = static_cast<int>(L - l0 < tl ? L - l0 : tl);
    const int64_t base = b0 * npl + l0;
    __syncthreads();  // the previous tile's readers are done
    for (int row = 0; row < nr; ++row) {
      const float* gr = xr + base + row * npl;
      const float* gi = xi + base + row * npl;
      float* sr = ar + row * per;
      float* si = ai + row * per;
      if (vec && width == tl) {
        const int t4sh = tsh - 2;
        const int c4 = (tl >> 2) - 1;
        for (int e = threadIdx.x; e < n * (tl >> 2); e += blockDim.x) {
          const int i = e >> t4sh;
          const int c = (e & c4) << 2;
          const int64_t k = i * L + c;
          *reinterpret_cast<float4*>(sr + (i << tsh) + c) =
              __ldg(reinterpret_cast<const float4*>(gr + k));
          *reinterpret_cast<float4*>(si + (i << tsh) + c) =
              __ldg(reinterpret_cast<const float4*>(gi + k));
        }
      } else {
        for (int e = threadIdx.x; e < per; e += blockDim.x) {
          const int i = e >> tsh;
          const int c = e & (tl - 1);
          float vr = 0.f, vi = 0.f;
          if (c < width) {
            vr = gr[i * L + c];
            vi = gi[i * L + c];
          }
          sr[e] = vr;
          si[e] = vi;
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nr * per; e += blockDim.x) {
      const int row = e / per;
      const int t = e - row * per;
      const int i = t >> tsh;
      const int c = t & (tl - 1);
      if (c < width) {
        const int64_t k = base + row * npl + i * L + c;
        yr[k] = 1.0001f * ar[e];
        yi[k] = 1.0001f * ai[e];
      }
    }
  }
}

__global__ void __launch_bounds__(kRowThreads, 2)
copy_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, int rows,
                 int n, int rpb) {
  extern __shared__ float4 smem4[];
  float* ar = reinterpret_cast<float*>(smem4);
  float* ai = ar + ((rpb * n + 3) & ~3);
  const bool vec = n % 4 == 0 && aligned16(xr) && aligned16(xi);
  const int groups = (rows + rpb - 1) / rpb;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * rpb;
    const int nr = rows - r0 < rpb ? static_cast<int>(rows - r0) : rpb;
    const int64_t off = r0 * n;
    __syncthreads();  // the previous group's readers are done
    if (vec) {
      for (int i = threadIdx.x; i < nr * n / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(ar)[i] =
            __ldg(reinterpret_cast<const float4*>(xr + off) + i);
        reinterpret_cast<float4*>(ai)[i] =
            __ldg(reinterpret_cast<const float4*>(xi + off) + i);
      }
    } else {
      for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
        ar[i] = xr[off + i];
        ai[i] = xi[off + i];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
      yr[off + i] = 1.0001f * ar[i];
      yi[off + i] = 1.0001f * ai[i];
    }
  }
}

template <class Fn>
int occupancy(Fn fn, int threads, int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, threads, static_cast<size_t>(smem)));
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// The entry points act on the caller's current device; the caller sets it.
// Each returns the CUDA error code, 0 on success.

// Allow the arm kMaxSmem bytes of dynamic shared memory and report how many
// blocks of `smem` bytes fit on one SM.
extern "C" int copy_inner_occupancy(int smem, int* blocks_per_sm) {
  return occupancy(copy_inner_kernel, kInnerThreads, smem, blocks_per_sm);
}

extern "C" int copy_rows_occupancy(int smem, int* blocks_per_sm) {
  return occupancy(copy_rows_kernel, kRowThreads, smem, blocks_per_sm);
}

// (pre, n, L) split planes in groups of gp planes of (n, tl) tiles, tl a
// power of two; smem = 8 * gp * n * tl bytes.
extern "C" int copy_inner_launch(const float* xr, const float* xi, float* yr,
                                 float* yi, int pre, int n, long long L,
                                 int tl, int gp, int grid, int smem,
                                 void* stream) {
  if (tl < 1 || (tl & (tl - 1)) || gp < 1 ||
      smem != static_cast<int>(sizeof(float)) * 2 * gp * n * tl)
    return static_cast<int>(cudaErrorInvalidValue);
  copy_inner_kernel<<<grid, kInnerThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, pre, n, static_cast<int64_t>(L), tl, gp);
  return static_cast<int>(cudaGetLastError());
}

// (rows, n) split planes in groups of rpb rows; smem = 8 * ceil4(rpb * n)
// bytes.
extern "C" int copy_rows_launch(const float* xr, const float* xi, float* yr,
                                float* yi, int rows, int n, int rpb,
                                int grid, int smem, void* stream) {
  if (rpb < 1 ||
      smem != static_cast<int>(sizeof(float)) * 2 * ((rpb * n + 3) & ~3))
    return static_cast<int>(cudaErrorInvalidValue);
  copy_rows_kernel<<<grid, kRowThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi,
                                                          rows, n, rpb);
  return static_cast<int>(cudaGetLastError());
}
