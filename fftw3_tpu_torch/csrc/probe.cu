// P1, the toolchain canary: y = G @ x for square float32 matrices, with an
// fp32 sum, hand-written for Hopper (sm_90a).  ``toolchain_probe.py`` builds
// the kernel library (every csrc/*.cu must compile under the installed
// toolkit), launches this kernel at 128 x 128 with G = I and with a seeded
// random G, and checks y against x and against float64 G @ x.
//
// Replaces the TPU canary fftw3_tpu/toolchain_probe.py
// (_probe_x64_ambient, its pl.pallas_call at :112): a trivial Mosaic
// kernel, y = G @ x at 128 x 128 with G = I, compiled under ambient x64 to
// see whether the TPU toolchain still crashed there.  The card has no x64
// question; what stands is whether csrc/ still builds and launches.
//
// Design: a grid of 16 x 16 tiles of y, one block of 16 x 16 threads each;
// the block walks the contraction in 16-wide steps, staging a tile of G and
// one of x in shared memory (padded one column against bank conflicts),
// each thread summing its output point in order.  What bounds it on an
// H100 at n = 128: nothing the card's rates set (3 x 64 KiB over HBM and
// 2 n^3 flops are both about 0.06 us); its time is the launch latency.

#include <cuda_runtime.h>

namespace fftw3_tpu_torch {
namespace {

constexpr int kTile = 16;

__global__ void __launch_bounds__(kTile * kTile)
probe_matmul_kernel(const float* __restrict__ g, const float* __restrict__ x,
                    float* __restrict__ y, int n) {
  __shared__ float gs[kTile][kTile + 1];
  __shared__ float xs[kTile][kTile + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;
  const int col = blockIdx.x * kTile + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    gs[ty][tx] = (row < n && k0 + tx < n) ? g[row * n + k0 + tx] : 0.f;
    xs[ty][tx] = (k0 + ty < n && col < n) ? x[(k0 + ty) * n + col] : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile; ++k) acc += gs[ty][k] * xs[k][tx];
    __syncthreads();
  }
  if (row < n && col < n) y[row * n + col] = acc;
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// y = G @ x for row-major (n, n) float32 G, x and y on the caller's current
// device, on `stream`.  Returns the CUDA error code of the launch, 0 on
// success.
extern "C" int probe_matmul_launch(const float* g, const float* x, float* y,
                                   int n, void* stream) {
  if (n < 1 || n > 16384) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTile, kTile);
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  probe_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      g, x, y, n);
  return static_cast<int>(cudaGetLastError());
}
