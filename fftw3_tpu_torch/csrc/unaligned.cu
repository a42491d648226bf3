// E1, the unaligned-row tax: timing-only kernels that compute y = 1.0001 * x
// on one f32 plane of (rows, n), to set a row length that is not a multiple
// of 32 (n = 1000) against one that is (n = 1024).  Hand-written for Hopper
// (sm_90a).  Nothing on a user's path reaches these entry points.
//
// Replaces the TPU measurement script experiments/copy1000.py (make_arm,
// pallas_call at :55), whose two kernels are a copy of (tb, n) blocks
// (_copy_kernel) and a copy through two in-VMEM transposes (tb, n) ->
// (n, tb) -> (tb, n) (_trans_kernel).  The TPU's block geometry has no
// meaning here; the two arms ask the same two questions in K1's terms:
//  * copy: K1's row geometry (stockham_rows.cuh): 256 threads, groups of
//    rpb = stockham.rows_per_block(n) whole rows, 16-byte loads into shared
//    memory when n % 4 == 0 and the plane is 16-byte aligned (every row
//    start of a 1000-float row is: 4000 bytes is a multiple of 16, not of
//    128), then 4-byte stores, consecutive across a warp, as K1's last
//    level stores;
//  * trans: tiles of kTransRows rows in shared memory padded as K1's first
//    level pads, e + (e >> 5); the tile is read column by column (the 16
//    rows of one column across a half warp: the counterpart of the
//    reference's (tb, n) -> (n, tb) transpose), scaled and written back
//    column by column to the same slots, then stored row by row.  A column
//    walks the rows at a stride of n plus its pads: at n = 1024 every row
//    of a column lands in one bank (1024 + 32 words is 0 mod 32), at
//    n = 1000 the rows spread over the banks.
// What bounds them on an H100: 8 bytes of HBM traffic per point (one f32
// read, one written), 0.040 ms at the reference's 16.6e6 points.

#include <cuda_runtime.h>
#include <stdint.h>

namespace fftw3_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kTransRows = 16;
// a cap on either arm's shared memory, set once
constexpr int kMaxSmem = 98304;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

__global__ void __launch_bounds__(kThreads, 2)
unaligned_copy_kernel(const float* __restrict__ x, float* __restrict__ y,
                      int rows, int n, int rpb) {
  extern __shared__ float4 smem4[];
  float* a = reinterpret_cast<float*>(smem4);
  const bool vec = n % 4 == 0 && aligned16(x);
  const int groups = (rows + rpb - 1) / rpb;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * rpb;
    const int nr = rows - r0 < rpb ? static_cast<int>(rows - r0) : rpb;
    const int64_t off = r0 * n;
    __syncthreads();  // the previous group's readers are done
    if (vec) {
      for (int i = threadIdx.x; i < nr * n / 4; i += blockDim.x)
        reinterpret_cast<float4*>(a)[i] =
            __ldg(reinterpret_cast<const float4*>(x + off) + i);
    } else {
      for (int i = threadIdx.x; i < nr * n; i += blockDim.x)
        a[i] = x[off + i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x)
      y[off + i] = 1.0001f * a[i];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
unaligned_trans_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int rows, int n) {
  extern __shared__ float4 smem4[];
  float* a = reinterpret_cast<float*>(smem4);
  const bool vec = n % 4 == 0 && aligned16(x);
  const int tiles = (rows + kTransRows - 1) / kTransRows;
  const int pts = kTransRows * n;
  for (int g = blockIdx.x; g < tiles; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * kTransRows;
    const int nr =
        rows - r0 < kTransRows ? static_cast<int>(rows - r0) : kTransRows;
    const int64_t off = r0 * n;
    __syncthreads();  // the previous tile's readers are done
    if (vec) {
      for (int i = threadIdx.x; i < nr * n / 4; i += blockDim.x) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(x + off) + i);
        const int e = 4 * i;  // e .. e + 3 share one run of 32: contiguous
        float* s = a + padded(e);
        s[0] = v.x;
        s[1] = v.y;
        s[2] = v.z;
        s[3] = v.w;
      }
    } else {
      for (int i = threadIdx.x; i < nr * n; i += blockDim.x)
        a[padded(i)] = x[off + i];
    }
    __syncthreads();
    // column by column: point t is row t % kTransRows of column t / it
    for (int t = threadIdx.x; t < pts; t += blockDim.x) {
      const int r = t % kTransRows;
      if (r < nr) {
        const int e = padded(r * n + t / kTransRows);
        a[e] = 1.0001f * a[e];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * n; i += blockDim.x)
      y[off + i] = a[padded(i)];
  }
}

template <class Fn>
int occupancy(Fn fn, int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kThreads, static_cast<size_t>(smem)));
}

int trans_smem(int n) {
  const int e = kTransRows * n;
  return static_cast<int>(sizeof(float)) * (e + (e - 1) / 32 + 1);
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// The entry points act on the caller's current device; the caller sets it.
// Each returns the CUDA error code, 0 on success.

extern "C" int unaligned_copy_occupancy(int smem, int* blocks_per_sm) {
  return occupancy(unaligned_copy_kernel, smem, blocks_per_sm);
}

extern "C" int unaligned_trans_occupancy(int smem, int* blocks_per_sm) {
  return occupancy(unaligned_trans_kernel, smem, blocks_per_sm);
}

// (rows, n) plane in groups of rpb rows; smem = 4 * ceil4(rpb * n) bytes.
extern "C" int unaligned_copy_launch(const float* x, float* y, int rows,
                                     int n, int rpb, int grid, int smem,
                                     void* stream) {
  if (rpb < 1 || n < 1 ||
      smem != static_cast<int>(sizeof(float)) * ((rpb * n + 3) & ~3))
    return static_cast<int>(cudaErrorInvalidValue);
  unaligned_copy_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(x, y, rows, n,
                                                               rpb);
  return static_cast<int>(cudaGetLastError());
}

// (rows, n) plane in tiles of kTransRows rows; smem = 4 * (e + (e - 1) / 32
// + 1) bytes for e = kTransRows * n, the padded tile.
extern "C" int unaligned_trans_launch(const float* x, float* y, int rows,
                                      int n, int grid, int smem,
                                      void* stream) {
  if (n < 1 || smem != trans_smem(n))
    return static_cast<int>(cudaErrorInvalidValue);
  unaligned_trans_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(x, y, rows,
                                                                n);
  return static_cast<int>(cudaGetLastError());
}
