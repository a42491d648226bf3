// E7, the four-step's swap as a kernel: split (B, p, q) f32 planes ->
// (B, q, p), y[b, j2, j1] = x[b, j1, j2].  Hand-written for Hopper
// (sm_90a).  Timing only: the pallas4 route (ops/fourstep.py) pays this
// swap as two transpose(-1, -2).contiguous() copies, and nothing on a user's
// path reaches this entry point.
//
// Replaces the TPU measurement script experiments/race4096.py
// (make_pallas_transpose, pallas_call at :59; its block 2 races it against
// XLA's swapaxes and a bare reshape), which reads natural (g, p, q) blocks,
// transposes each in VMEM and pays the narrow lane dimension p only on its
// store.  Here a block takes one (p, q) matrix of both planes at a time:
// 16-byte loads along q into shared memory at a row stride of q + 4 floats
// (rows stay 16-byte aligned), then each thread reads 4 consecutive points
// of one row j1 as one 16-byte shared load (lanes on consecutive rows: with
// q % 32 == 0 a quarter warp's loads cover the 32 banks once) and stores
// them as 4 floats to output rows j2 .. j2 + 3 at column j1, so that a warp
// writes whole output rows of p floats (p * 4 = 128 bytes at the
// measurement's p = 32: the narrow store is what is measured).
// What bounds it on an H100: 16 bytes of HBM traffic per point, 0.040 ms
// at (2048, 32, 128).

#include <cuda_runtime.h>
#include <stdint.h>

namespace fftw3_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;
// a cap on the kernel's shared memory, set once
constexpr int kMaxSmem = 98304;

__global__ void __launch_bounds__(kThreads)
swap_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            float* __restrict__ yr, float* __restrict__ yi, int batch, int p,
            int q) {
  extern __shared__ float4 smem4[];
  float* ar = reinterpret_cast<float*>(smem4);
  const int rs = q + kPad;
  float* ai = ar + p * rs;
  const int q4 = q / 4;
  const int m4 = p * q4;
  const int64_t pq = static_cast<int64_t>(p) * q;
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const float4* gr = reinterpret_cast<const float4*>(xr + b * pq);
    const float4* gi = reinterpret_cast<const float4*>(xi + b * pq);
    __syncthreads();  // the previous matrix's readers are done
    for (int i = threadIdx.x; i < m4; i += blockDim.x) {
      const int j1 = i / q4;
      const int c = 4 * (i - j1 * q4);
      *reinterpret_cast<float4*>(ar + j1 * rs + c) = __ldg(gr + i);
      *reinterpret_cast<float4*>(ai + j1 * rs + c) = __ldg(gi + i);
    }
    __syncthreads();
    float* orow = yr + b * pq;
    float* oirow = yi + b * pq;
    for (int i = threadIdx.x; i < m4; i += blockDim.x) {
      const int j1 = i % p;  // rows fastest: a warp writes along j1
      const int j2 = 4 * (i / p);
      const float4 vr = *reinterpret_cast<const float4*>(ar + j1 * rs + j2);
      const float4 vi = *reinterpret_cast<const float4*>(ai + j1 * rs + j2);
      orow[(j2 + 0) * p + j1] = vr.x;
      orow[(j2 + 1) * p + j1] = vr.y;
      orow[(j2 + 2) * p + j1] = vr.z;
      orow[(j2 + 3) * p + j1] = vr.w;
      oirow[(j2 + 0) * p + j1] = vi.x;
      oirow[(j2 + 1) * p + j1] = vi.y;
      oirow[(j2 + 2) * p + j1] = vi.z;
      oirow[(j2 + 3) * p + j1] = vi.w;
    }
  }
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// The entry points act on the caller's current device; the caller sets it.
// Each returns the CUDA error code, 0 on success.

// Allow the kernel kMaxSmem bytes of dynamic shared memory and report how
// many blocks of `smem` bytes fit on one SM.
extern "C" int swap_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      swap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, swap_kernel, kThreads, static_cast<size_t>(smem)));
}

// (batch, p, q) split planes, 16-byte aligned, q % 4 == 0; smem = 8 * p *
// (q + 4) bytes.
extern "C" int swap_launch(const float* xr, const float* xi, float* yr,
                           float* yi, int batch, int p, int q, int grid,
                           int smem, void* stream) {
  if (p < 1 || q < 4 || q % 4 ||
      smem != static_cast<int>(sizeof(float)) * 2 * p * (q + kPad))
    return static_cast<int>(cudaErrorInvalidValue);
  swap_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, batch,
                                                     p, q);
  return static_cast<int>(cudaGetLastError());
}
