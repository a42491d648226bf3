// Batched 2-D complex-to-complex FFT over both trailing axes of split f32
// planes (pre, n1, n2) -> (pre, n1, n2) in one launch.  Hand-written for
// Hopper (sm_90a).
//
// Replaces the fused Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_2d, reached through _make_call_2d.
// Like it, it runs the n2 schedule along the rows and then the n1 schedule
// along the columns, each stage as _stages computes it.  Unnormalized.
//
// What bounds it on an H100: one read and one write of the plane from HBM,
// 16 bytes per point.  The TPU kernel holds a whole plane in VMEM.  A plane
// here is up to 294,912 points (2.4 MB split), ten times a block's 227 KB
// of shared memory, so one thread-block cluster owns a plane instead:
//  1. Row pass: each block takes chunks of whole rows, runs the n2 schedule
//     and writes the rows to the output tensor.  A first level of
//     butterflies reads the rows from the input directly; a dense first
//     stage reads them from shared memory, filled with 16-byte loads.
//  2. The cluster synchronises: __threadfence() and then cluster.sync(), so
//     every row of the plane is in the output before any block reads it.
//  3. Column pass: each block takes (n1, tc) tiles of tc whole columns from
//     the output (16-byte __ldcg loads: the data was written by other SMs
//     during this launch, and only L2 is coherent between them), runs the
//     n1 schedule along axis -2 with one column's butterfly per thread
//     (consecutive threads on consecutive columns) and writes the tile back
//     in place.
// The stages are the register butterflies of stockham_bfly.cuh (a radix
// with a prime factor of 7 or more keeps the dense sum); a butterfly level
// runs in place, so a tile needs one buffer (two only with a dense stage):
// at 8192 points and the tables about 90 KB.  A block of 512 threads holds
// 16 points a thread in a level and takes up to 128 registers, so one block
// runs per SM.  A cluster is 8 blocks, the portable size (16, and the plane
// held in the distributed shared memory of a 16-block cluster, were slower:
// PERF.md): about 132/8 planes are in flight, and they must stay in the
// 50 MB L2 between the two passes for HBM to see one read and one write per
// point.
//
// An interleaved complex64 output (kLayout kOutC, the same kernel): yr is
// the caller's complex output, each point a float2 (re, im), and yi is
// unused; the input stays in planes.  The row pass stores a float2 a point,
// the column pass loads its tiles from that output with __ldcg (two points
// a 16-byte load, four loads in flight, when tc and n2 are even and the
// output 16-byte aligned, else 8-byte) and stores them back in place in the
// same layout.  A plane is the same 2 MiB, so the L2 argument above holds
// unchanged.  A multi-axis plan's last pass writes the caller's output so,
// and no conversion pass runs after it.

#include <cooperative_groups.h>

#include "stockham_bfly.cuh"

namespace cg = cooperative_groups;

namespace fftw3_tpu_torch {
namespace {

using fftw3_tpu_torch::Arm;
using fftw3_tpu_torch::Level;
using fftw3_tpu_torch::LevelPlan;
using fftw3_tpu_torch::kMaxLevels;
using fftw3_tpu_torch::read_plan;
using fftw3_tpu_torch::run_levels;
using fftw3_tpu_torch::stage_levels;

// threads per block and the blocks per SM the registers are held to (one:
// 128 a thread; at two the levels spill): the best of the sweep in PERF.md
constexpr int kThreads = 512;
constexpr int kMinBlocks = 1;
// points a thread holds in one level: tiles of 8192 points
constexpr int kPts = 8192 / kThreads;
constexpr int kTilePoints = kPts * kThreads;
// blocks per plane (fused2d.CLUSTER)
constexpr int kCluster = 8;
// a cap on any pair of plans' shared memory, set once
constexpr int kMaxSmem = 180224;

// Row pass store: point o of row `row` of the chunk.
struct RowsMap {
  int64_t base;  // element (plane, r0, 0)
  int n2;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int64_t operator()(int row, int o, int) const {
    return base + static_cast<int64_t>(row) * n2 + o;
  }
};

// Column pass store: point o of column c of the tile, in place.
struct ColsMap {
  int64_t base;  // element (plane, 0, c0)
  int n2;
  int width;
  __device__ __forceinline__ bool stored(int c) const { return c < width; }
  __device__ __forceinline__ int64_t operator()(int, int o, int c) const {
    return base + static_cast<int64_t>(o) * n2 + c;
  }
};

// The same stores of one float2 a point to an interleaved complex output.
struct RowsMapC : RowsMap {
  static constexpr bool kInterleaved = true;
};
struct ColsMapC : ColsMap {
  static constexpr bool kInterleaved = true;
};

// 16-byte loads a thread issues before their stores in the column pass of an
// interleaved output: these L2 reads are latency-bound; at 512^3 on an H100
// one in flight took 4.51 ms, two 4.29, four 4.11, the planes' loop (two,
// one a plane) 4.21 (PERF.md)
constexpr int kColLoads = 4;

// The column pass's load of an (n1, tc) tile of columns c0 .. c0 + width of
// an interleaved output, rows n2 apart from yc (element (plane, 0, c0)),
// into (ar, ai) at i * tc + c (tc a power of two); with vec (a full tile)
// two columns a 16-byte load, kColLoads of them issued before their stores
// (an index past the tile reloads the last element, not stored), else the
// columns from width on are zero.
__device__ __forceinline__ void load_cols_c(const float2* yc, int n1, int n2,
                                            int tc, int width, float* ar,
                                            float* ai, bool vec) {
  if (vec) {
    const int t2 = tc >> 1;
    const int sh = __ffs(t2) - 1;
    const int total = n1 * t2;
    const int step = blockDim.x;
    for (int e = threadIdx.x; e < total; e += kColLoads * step) {
      float4 v[kColLoads];
#pragma unroll
      for (int u = 0; u < kColLoads; ++u) {
        const int f = min(e + u * step, total - 1);
        v[u] = __ldcg(reinterpret_cast<const float4*>(
            yc + static_cast<int64_t>(f >> sh) * n2 + ((f & (t2 - 1)) << 1)));
      }
#pragma unroll
      for (int u = 0; u < kColLoads; ++u) {
        const int f = e + u * step;
        if (f < total) {
          const int o = (f >> sh) * tc + ((f & (t2 - 1)) << 1);
          *reinterpret_cast<float2*>(ar + o) = make_float2(v[u].x, v[u].z);
          *reinterpret_cast<float2*>(ai + o) = make_float2(v[u].y, v[u].w);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < n1 * tc; e += blockDim.x) {
      const int i = e / tc;
      const int c = e - i * tc;
      float2 v = make_float2(0.f, 0.f);
      if (c < width) v = __ldcg(yc + static_cast<int64_t>(i) * n2 + c);
      ar[e] = v.x;
      ai[e] = v.y;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__host__ __device__ inline int buffer_plane(const LevelPlan& p2,
                                            const LevelPlan& p1, int rows) {
  const int a = rows * p2.rs, b = p1.rs;
  return ((a > b ? a : b) + 3) & ~3;
}

__host__ __device__ inline int smem_bytes(const LevelPlan& p2,
                                          const LevelPlan& p1, int rows) {
  const int nbuf = p2.nbuf > p1.nbuf ? p2.nbuf : p1.nbuf;
  return static_cast<int>(sizeof(float)) *
         (((p2.tab_len + p1.tab_len + 3) & ~3) +
          2 * nbuf * buffer_plane(p2, p1, rows));
}

// yr, yi are written by the row pass and read back by other blocks of the
// cluster in the column pass: no __restrict__ and no read-only loads on them.
template <int kLayout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    c2c_2d_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* yr, float* yi, const float* __restrict__ tab,
                  const LevelPlan plan2, const LevelPlan plan1, int pre,
                  int n1, int n2, int rows, int tc) {
  constexpr bool kCout = kLayout == kOutC;
  static_assert(kLayout == 0 || kCout, "planes, or an interleaved output");
  extern __shared__ float4 smem4[];
  __shared__ Level lev2[kMaxLevels], lev1[kMaxLevels];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float* tb2 = reinterpret_cast<float*>(smem4);
  float* tb1 = tb2 + plan2.tab_len;
  const int plane = buffer_plane(plan2, plan1, rows);
  float* ar = tb2 + ((plan2.tab_len + plan1.tab_len + 3) & ~3);
  float* ai = ar + plane;
  float* br = ai + plane;  // second buffer, only with a dense stage
  float* bi = br + plane;

  stage_levels(plan2, lev2);
  stage_levels(plan1, lev1);
  const int tab_len = plan2.tab_len + plan1.tab_len;
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb2[i] = tab[i];
  const bool vrow = aligned16(xr) && aligned16(xi) && n2 % 4 == 0 &&
                    plan2.rs % 4 == 0 &&
                    (kCout || (aligned16(yr) && aligned16(yi)));
  const bool vcol =
      kCout ? aligned16(yr) && n2 % 2 == 0 && tc % 2 == 0
            : aligned16(xr) && aligned16(xi) && aligned16(yr) &&
                  aligned16(yi) && n2 % 4 == 0 && tc % 4 == 0;
  // a first level of butterflies reads the rows from the input
  const bool direct = plan2.lev[0].kind != 0;

  const int64_t npts = static_cast<int64_t>(n1) * n2;
  for (int64_t plane_i = blockIdx.x / csize; plane_i < pre;
       plane_i += gridDim.x / csize) {
    const int64_t poff = plane_i * npts;
    // 1. rows: chunks of `rows` whole rows, block `rank` takes every
    //    csize-th chunk
    for (int r0 = rank * rows; r0 < n1; r0 += csize * rows) {
      const int nr = n1 - r0 < rows ? n1 - r0 : rows;
      const int64_t base = poff + static_cast<int64_t>(r0) * n2;
      __syncthreads();  // levels and tables staged; previous chunk's
                        // readers are done
      if (!direct) {
        if (vrow) {
          const int m4 = n2 / 4;
          for (int i = threadIdx.x; i < nr * m4; i += blockDim.x) {
            const int row = i / m4;
            const int k = 4 * (i - row * m4);
            const int64_t g = base + static_cast<int64_t>(row) * n2 + k;
            *reinterpret_cast<float4*>(ar + row * plan2.rs + k) =
                __ldg(reinterpret_cast<const float4*>(xr + g));
            *reinterpret_cast<float4*>(ai + row * plan2.rs + k) =
                __ldg(reinterpret_cast<const float4*>(xi + g));
          }
        } else {
          for (int i = threadIdx.x; i < nr * n2; i += blockDim.x) {
            const int row = i / n2;
            const int k = i - row * n2;
            ar[row * plan2.rs + k] = xr[base + i];
            ai[row * plan2.rs + k] = xi[base + i];
          }
        }
        __syncthreads();
      }
      const float* x0r = direct ? xr + base : nullptr;
      const float* x0i = direct ? xi + base : nullptr;
      if constexpr (kCout)
        run_levels<kPts, Arm::kFull>(plan2, lev2, tb2, ar, ai, br, bi, n2, 1,
                                     nr, yr, yi, RowsMapC{{base, n2}}, x0r,
                                     x0i, n2);
      else
        run_levels<kPts, Arm::kFull>(plan2, lev2, tb2, ar, ai, br, bi, n2, 1,
                                     nr, yr, yi, RowsMap{base, n2}, x0r, x0i,
                                     n2);
    }
    // 2. every row of the plane is written before any column is read
    __threadfence();
    cluster.sync();
    // 3. columns: tiles of tc whole columns, in place
    for (int c0 = rank * tc; c0 < n2; c0 += csize * tc) {
      const int width = n2 - c0 < tc ? n2 - c0 : tc;
      const int64_t base = poff + c0;
      __syncthreads();  // previous tile's readers are done
      if constexpr (kCout) {
        load_cols_c(reinterpret_cast<const float2*>(yr) + base, n1, n2, tc,
                    width, ar, ai, vcol && width == tc);
      } else if (vcol && width == tc) {
        const int t4 = tc / 4;
        for (int e = threadIdx.x; e < n1 * t4; e += blockDim.x) {
          const int i = e / t4;
          const int c = 4 * (e - i * t4);
          const int64_t k = base + static_cast<int64_t>(i) * n2 + c;
          *reinterpret_cast<float4*>(ar + i * tc + c) =
              __ldcg(reinterpret_cast<const float4*>(yr + k));
          *reinterpret_cast<float4*>(ai + i * tc + c) =
              __ldcg(reinterpret_cast<const float4*>(yi + k));
        }
      } else {
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
      }
      __syncthreads();
      if constexpr (kCout)
        run_levels<kPts, Arm::kFull>(plan1, lev1, tb1, ar, ai, br, bi, n1,
                                     tc, 1, yr, yi,
                                     ColsMapC{{base, n2, width}});
      else
        run_levels<kPts, Arm::kFull>(plan1, lev1, tb1, ar, ai, br, bi, n1,
                                     tc, 1, yr, yi, ColsMap{base, n2, width});
    }
  }
}

cudaLaunchConfig_t make_config(int grid, int smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// Both entry points act on the caller's current device; the caller sets it.

// Allow the kernel kMaxSmem bytes of dynamic shared memory on the current
// device and report how many clusters of kCluster blocks of `smem` bytes the
// whole card runs at once.  Returns the CUDA error code, 0 on success.
extern "C" int c2c_2d_occupancy(int smem, int* clusters) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  for (auto fn : {c2c_2d_kernel<0>, c2c_2d_kernel<kOutC>}) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = make_config(kCluster, smem, nullptr, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, c2c_2d_kernel<0>, &cfg));
}

// Launch `grid` blocks (a multiple of kCluster) in clusters of kCluster on
// `stream`, with the host's level plans of the n2 schedule (tl = 1) and the
// n1 schedule (tl = tc), each 4 + 8 * nlev ints (stockham.level_plan).
// Returns the CUDA error code of the launch, 0 on success.  The caller
// checks shapes: pre >= 1, rows * n2 and n1 * tc within kTilePoints, tc a
// power of two, tab holding the n2 table (plan2's tab_len floats) and then
// the n1 table, smem as smem_bytes computes it, allowed by
// c2c_2d_occupancy.  `layout` is 0 (split planes) or kOutC (yr an
// interleaved complex output, yi unused).
extern "C" int c2c_2d_launch(const float* xr, const float* xi, float* yr,
                             float* yi, const float* tab, const int* plan2,
                             const int* plan1, int pre, int n1, int n2,
                             int rows, int tc, int layout, int grid, int smem,
                             void* stream) {
  LevelPlan p2, p1;
  if (!read_plan(plan2, 1, &p2) || !read_plan(plan1, tc, &p1) ||
      rows * n2 > kTilePoints || n1 * tc > kTilePoints || grid % kCluster ||
      smem != smem_bytes(p2, p1, rows) || (tc & (tc - 1)) ||
      (layout != 0 && layout != kOutC))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      make_config(grid, smem, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, layout == kOutC ? c2c_2d_kernel<kOutC> : c2c_2d_kernel<0>, xr, xi,
      yr, yi, tab, p2, p1, pre, n1, n2, rows, tc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
