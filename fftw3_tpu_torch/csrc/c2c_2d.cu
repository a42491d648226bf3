// Batched 2-D complex-to-complex FFT over both trailing axes of split f32
// planes (pre, n1, n2) -> (pre, n1, n2) in one launch.  Hand-written for
// Hopper (sm_90a).
//
// Replaces the fused Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_2d, reached through _make_call_2d.
// Like it, it runs the n2 schedule along the rows and then the n1 schedule
// along the columns, each stage as _stages computes it (stockham_stage.cuh).
// Unnormalized.
//
// What bounds it on an H100: one read and one write of the plane from HBM,
// 16 bytes per point, against two dense-sum schedules of arithmetic.  The TPU
// kernel holds a whole plane in VMEM.  A plane here is up to 294,912 points
// (2.4 MB split), ten times a block's 227 KB of shared memory, so this design
// cannot copy it.  Instead one thread-block cluster (8 blocks, the portable
// size) owns a plane:
//  1. Row pass: each block takes whole rows, a chunk at a time, into shared
//     memory, runs the n2 stages and writes the rows to the output tensor.
//  2. The cluster synchronises: __threadfence() and then cluster.sync(), so
//     every row of the plane is in the output before any block reads it.
//  3. Column pass: each block takes (n1, tc) tiles of tc whole columns from
//     the output, runs the n1 stages along axis -2 and writes them back in
//     place.  These reads bypass L1 (__ldcg): the data was written by other
//     SMs during this launch, and only L2 is coherent between them.
// Only about 16 clusters run at once (one block per SM), so at most ~38 MB of
// planes are in flight: a plane stays in the 50 MB L2 between the two passes
// and HBM sees about one read and one write per point, as on the TPU.
//
// Tiles: a row chunk is R rows with R*n2 <= 8192 points, a column tile tc
// columns (a power of two) with n1*tc <= 8192; two split buffers of 64 KB.
// Clusters walk the planes with a grid stride, so any pre works.

#include <cooperative_groups.h>

#include "stockham_stage.cuh"

namespace cg = cooperative_groups;

namespace {

using fftw3_tpu_torch::run_stages;
using fftw3_tpu_torch::Schedule;

constexpr int kThreads = 512;
constexpr int kTilePoints = 8192;

// Row pass store: point o of row `row` of the chunk (counted from element
// (plane, r0, 0)).
struct RowsMap {
  int n2;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int64_t operator()(int row, int o, int) const {
    return static_cast<int64_t>(row) * n2 + o;
  }
};

// Column pass store: point o of column c of the tile, in place (counted from
// element (plane, 0, c0)).
struct ColsMap {
  int n2;
  int width;
  __device__ __forceinline__ bool stored(int c) const { return c < width; }
  __device__ __forceinline__ int64_t operator()(int, int o, int c) const {
    return static_cast<int64_t>(o) * n2 + c;
  }
};

// yr, yi are written by the row pass and read back by other blocks of the
// cluster in the column pass: no __restrict__ and no read-only loads on them
// here (inside one stage, where they are only stored to, they are).
__global__ void __launch_bounds__(kThreads)
c2c_2d_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              float* yr, float* yi, const float* __restrict__ tab,
              int tab2_len, int tab1_len, int pre, int n1, int n2, int rows,
              int tc, int ns2, int p20, int p21, int ns1, int p10, int p11) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = rows * n2 > n1 * tc ? rows * n2 : n1 * tc;
  float* tb2 = smem;
  float* tb1 = smem + tab2_len;
  float* ar = tb1 + tab1_len;
  float* ai = ar + tile;
  float* br = ai + tile;
  float* bi = br + tile;

  const int tab_len = tab2_len + tab1_len;
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb2[i] = tab[i];
  const Schedule sched2(tb2, n2, ns2, p20, p21);
  const Schedule sched1(tb1, n1, ns1, p10, p11);

  const int64_t npts = static_cast<int64_t>(n1) * n2;
  for (int64_t plane = blockIdx.x / csize; plane < pre;
       plane += gridDim.x / csize) {
    const int64_t poff = plane * npts;
    // 1. rows: chunks of `rows` whole rows, block `rank` takes every
    //    csize-th chunk
    for (int r0 = rank * rows; r0 < n1; r0 += csize * rows) {
      const int nr = n1 - r0 < rows ? n1 - r0 : rows;
      const int64_t base = poff + static_cast<int64_t>(r0) * n2;
      __syncthreads();  // tables staged; previous chunk's readers are done
      for (int e = threadIdx.x; e < nr * n2; e += blockDim.x) {
        ar[e] = xr[base + e];
        ai[e] = xi[base + e];
      }
      __syncthreads();
      run_stages(ar, ai, br, bi, sched2, 1, nr, yr + base, yi + base,
                 RowsMap{n2});
    }
    // 2. every row of the plane is written before any column is read
    __threadfence();
    cluster.sync();
    // 3. columns: tiles of tc whole columns, in place
    for (int c0 = rank * tc; c0 < n2; c0 += csize * tc) {
      const int width = n2 - c0 < tc ? n2 - c0 : tc;
      const int64_t base = poff + c0;
      __syncthreads();  // previous tile's readers are done
      for (int e = threadIdx.x; e < n1 * tc; e += blockDim.x) {
        const int i = e / tc;
        const int c = e - i * tc;
        float vr = 0.f, vi = 0.f;
        if (c < width) {
          const int64_t k = base + static_cast<int64_t>(i) * n2 + c;
          vr = __ldcg(yr + k);
          vi = __ldcg(yi + k);
        }
        ar[e] = vr;
        ai[e] = vi;
      }
      __syncthreads();
      run_stages(ar, ai, br, bi, sched1, tc, 1, yr + base, yi + base,
                 ColsMap{n2, width});
    }
  }
}

// The most dynamic shared memory any valid pair of schedules asks for: two
// root tables of at most 2*256 + 2*2048 + 2*256 floats each and four planes
// of kTilePoints floats (172032 bytes).
constexpr int kMaxSmem = static_cast<int>(sizeof(float)) *
                         (2 * (2 * 256 + 2 * 2048 + 2 * 256) +
                          4 * kTilePoints);

cudaLaunchConfig_t make_config(int grid, int smem, int csize,
                               cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(csize);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Both entry points act on the caller's current device; the caller sets it.

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device and report how many clusters of `csize` blocks of `smem` bytes the
// whole card runs at once.  Returns the CUDA error code, 0 on success.
extern "C" int c2c_2d_occupancy(int smem, int csize, int* clusters) {
  if (smem > kMaxSmem || csize < 1 || csize > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      c2c_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = make_config(csize, smem, csize, nullptr, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, c2c_2d_kernel, &cfg));
}

// Launch `grid` blocks (a multiple of csize) in clusters of `csize` on
// `stream`.  Returns the CUDA error code of the launch, 0 on success.  The
// caller checks shapes: pre >= 1, n1 and n2 each p0 or p0 * p1 with radices
// <= 256 and n <= 2048, rows * n2 <= 8192 and n1 * tc <= 8192, tab holding
// the n2 table (tab2_len floats) and then the n1 table, smem = 4 * (tab2_len
// + tab1_len + 4 * max(rows * n2, n1 * tc)) bytes, allowed by
// c2c_2d_occupancy.
extern "C" int c2c_2d_launch(const float* xr, const float* xi, float* yr,
                             float* yi, const float* tab, int tab2_len,
                             int tab1_len, int pre, int n1, int n2, int rows,
                             int tc, int ns2, int p20, int p21, int ns1,
                             int p10, int p11, int grid, int csize, int smem,
                             void* stream) {
  if (rows * n2 > kTilePoints || n1 * tc > kTilePoints || grid % csize)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = make_config(
      grid, smem, csize, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, c2c_2d_kernel, xr, xi, yr, yi, tab, tab2_len, tab1_len, pre, n1,
      n2, rows, tc, ns2, p20, p21, ns1, p10, p11);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
