// Batched 2-D complex-to-complex FFT over both trailing axes of split f32
// planes (pre, n1, n2) -> (pre, n1, n2) in one launch.  Hand-written for
// Hopper (sm_90a).
//
// Replaces the fused Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/pallas_stockham.py, _kernel_2d, reached through _make_call_2d.
// Like it, it runs the n2 schedule along the rows and then the n1 schedule
// along the columns, each stage as _stages computes it.  Unnormalized.
//
// The bound on an H100: one read and one write of the plane from HBM, 16
// bytes per point (0.641 ms at 512^3).  The TPU kernel holds a whole plane
// in VMEM.  A plane here is up to 294,912 points (2.4 MB split), ten times a
// block's 227 KB of shared memory, so one thread-block cluster owns a plane:
//  1. Row pass: each block takes chunks of `rows` whole rows, runs the n2
//     schedule and writes the rows to the output tensor.
//  2. The cluster synchronises: __threadfence() and then cluster.sync(), so
//     every row of the plane is in the output before any block reads it.
//  3. Column pass: each block takes (n1, tc) tiles of tc whole columns from
//     the output (the data was written by other SMs during this launch, and
//     only L2 is coherent between them), runs the n1 schedule along axis -2
//     with one column's butterfly per thread (consecutive threads on
//     consecutive columns) and writes the tile back in place.
// The stages are the register butterflies of stockham_bfly.cuh (a radix
// with a prime factor of 7 or more keeps the dense sum); a butterfly level
// runs in place, so a tile needs one buffer (two with a dense stage): at
// 8192 points and the tables about 90 KB.  A block of 512 threads holds 16
// points a thread in a level and takes up to 128 registers, so one block
// runs per SM.  A cluster is 8 blocks, the portable size (16, and the plane
// held in the distributed shared memory of a 16-block cluster, were slower:
// PERF.md): about 132/8 planes are in flight, and they must stay in the 50
// MB L2 between the two passes for HBM to see one read and one write per
// point.
//
// Two forms walk the tiles, chosen by the host (fused2d.ring_fits) and bit
// for bit the same:
//  - The ring (ring_walk), wherever no stage is dense, n2 and tc are
//    multiples of 4 and the tensors 16-byte aligned: a block walks its tiles
//    in one sequence, rows of plane p, the barrier, columns of plane p, rows
//    of plane p + 1, ..., through two tile buffers.  Before the levels of a
//    tile the copy of the next starts into the other buffer: a row chunk
//    by thread 0 as two bulk copies (cp.async.bulk, whole rows are
//    contiguous) that complete an mbarrier, a column tile by every thread
//    as 16-byte cp.async pieces from L2 in one commit group.  Two working
//    buffers, and not a staging buffer unpacked into one: the first level
//    reads the tile where it landed (a row chunk at the input's stride n2,
//    an interleaved column tile as float2) and writes its own layout in
//    place, so no pass and no sync is added; the price is the second
//    padded buffer, 170,752 bytes at 512 x 512 against 89,856.  Only the
//    first column tile of a plane waits, behind the cluster barrier.
//  - In order (the rest, e.g. under a dense stage, whose second buffer the
//    ring would need): copy in, sync, levels, next tile.  A first butterfly
//    level reads the rows from the input directly, a dense one from shared
//    memory filled with 16-byte loads; the column tiles are loaded with
//    16-byte __ldcg loads.
// Two forms run the levels, chosen by the host (fused2d.fixed_fits), for
// either walk and bit for bit the same:
//  - Run-time plans (every schedule): plan2 and plan1 arrive as kernel
//    arguments, are staged in shared memory, and each level reads its
//    radix, strides, pads and table offsets there, divides through FastDiv
//    and switches on its radix (run_levels, bfly_any).  One body serves
//    every schedule, and ptxas holds the union of every radix's level: 128
//    registers, spill stores 4520 / 4508 bytes in order (planes / complex64
//    out), 4428 / 7392 on the ring (the complex64 column pass instantiates
//    the interleaved first level too), stack 560-592 bytes, which the
//    ring's L1 of 60 KB cannot hold (a block's stack is 300 KB).
//  - Compiled in (kFixed): a 512 x 512 plane on [32, 16] both ways, the
//    schedule ESTIMATE gives 512 and the users' 512^3 grid runs.  The plans
//    are the constants FixedRows and FixedCols (run_fixed_levels): each of
//    the three levels, radices 8, 4 and 16, is the one bfly_level body of
//    its radix with every index a constant; nothing is staged and no
//    FastDiv runs.  ptxas: 121-128 registers, no spill stores, no stack, in
//    all four (layout, walk) forms.  The host asks for it exactly when its
//    level plans equal fused2d.FIXED_PLANS, and the launch refuses it
//    unless they equal the constants here: a change of
//    stockham.level_plan sends 512 x 512 to the run-time form, not to
//    stale constants.
// What bounds K3, at 512^3 on an H100 (PERF.md), writing complex64 on the
// ring: with the run-time plans the levels (3.38-3.42 ms; with the levels
// taken out the ring moves the same bytes, same copies, plain stores and
// cluster barriers, in 1.46 ms); compiled in, 1.61-1.64 ms, near that
// floor.  In order it took 4.10-4.19 ms with the run-time plans.  The
// ring's larger shared memory leaves L1 60 KB of the SM's 256 where the
// in-order form leaves 156: the in-order form given the ring's shared
// memory ran 3.8-5.3% slower.
//
// An interleaved complex64 output (kLayout kOutC, the same kernel): yr is
// the caller's complex output, each point a float2 (re, im), and yi is
// unused; the input stays in planes.  The row pass stores a float2 a point,
// the column pass loads its tiles from that output (in order with __ldcg:
// two points a 16-byte load, four loads in flight, when tc and n2 are even
// and the output 16-byte aligned, else 8-byte) and stores them back in
// place in the same layout.  A plane is the same 2 MiB, so the L2 argument
// above holds unchanged.  A multi-axis plan's last pass writes the caller's
// output so, and no conversion pass runs after it.

#include <cooperative_groups.h>

#include "stockham_bfly.cuh"

namespace cg = cooperative_groups;

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

// The level plans compiled in (the form kFixed): a 512 x 512 plane on the
// schedule [32, 16] both ways (ESTIMATE's at 512: bfly 32=8x4, bfly 16),
// chunks of 16 rows and tiles of 16 columns; stockham.level_plan(512,
// (32, 16), tl) at tl = 1 and 16, which fused2d.FIXED_PLANS repeats.
constexpr int kFixedN = 512, kFixedChunk = 16;
struct FixedRows {
  static constexpr int tl = 1;
  static constexpr int plan[] = {3,  1,  632, 1120, 8,    8, 1,   512, 64, 0,
                                 512, 1, 4,   4,    8,    64, 64, 0,   512, 8,
                                 16, 16, 32,  16,   1088, 0,  16, 0};
};
struct FixedCols {
  static constexpr int tl = 16;
  static constexpr int plan[] = {3,  1,  9212, 1120, 8,    8, 1,   512, 64, 0,
                                 512, 4, 4,    4,    8,    64, 64, 0,   512, 0,
                                 16, 16, 32,   16,   1088, 0,  16, 0};
};

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

template <bool kCout>
__device__ __forceinline__ auto rows_map(int64_t base, int n2) {
  if constexpr (kCout)
    return RowsMapC{{base, n2}};
  else
    return RowsMap{base, n2};
}

template <bool kCout>
__device__ __forceinline__ auto cols_map(int64_t base, int n2, int width) {
  if constexpr (kCout)
    return ColsMapC{{base, n2, width}};
  else
    return ColsMap{base, n2, width};
}

// The levels of a row chunk of nr rows, level 0 reading them at (x0r, x0i),
// rows n2 apart (the input, or the ring buffer the chunk landed in; null:
// the buffer (ar, ai), where a dense first stage reads them), the last
// storing through map.  kFixed: the plan compiled in, whose chunks hold
// kFixedChunk rows.
template <bool kFixed, class Map>
__device__ __forceinline__ void row_levels(
    const LevelPlan& plan, const Level* lev, const float* tb, float* ar,
    float* ai, float* br, float* bi, int n2, int nr, float* yr, float* yi,
    const Map& map, const float* x0r, const float* x0i) {
  if constexpr (kFixed)
    run_fixed_levels<kPts, FixedRows, Arm::kFull>(
        tb, x0r, x0i, kFixedN, 1, ar, ai, kFixedChunk, yr, yi, map);
  else
    run_levels<kPts, Arm::kFull>(plan, lev, tb, ar, ai, br, bi, n2, 1, nr,
                                 yr, yi, map, x0r, x0i, n2);
}

// The levels of a column tile of tc columns in the buffer (ar, ai), with
// kSrcC interleaved in ar (as the ring's copy lands it), the last storing
// through map.  kFixed: the plan compiled in.
template <bool kFixed, bool kSrcC, class Map>
__device__ __forceinline__ void col_levels(
    const LevelPlan& plan, const Level* lev, const float* tb, float* ar,
    float* ai, float* br, float* bi, int n1, int tc, float* yr, float* yi,
    const Map& map) {
  if constexpr (kFixed)
    run_fixed_levels<kPts, FixedCols, Arm::kFull, kSrcC>(
        tb, ar, kSrcC ? nullptr : ai,
        kSrcC ? 0 : FixedLevel<FixedCols, 0>::rs, FixedCols::tl, ar, ai, 1,
        yr, yi, map);
  else if constexpr (kSrcC)
    run_levels<kPts, Arm::kFull, true>(plan, lev, tb, ar, ai, br, bi, n1, tc,
                                       1, yr, yi, map, ar, nullptr, 0, tc);
  else
    run_levels<kPts, Arm::kFull>(plan, lev, tb, ar, ai, br, bi, n1, tc, 1,
                                 yr, yi, map);
}

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

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__host__ __device__ inline int buffer_plane(const LevelPlan& p2,
                                            const LevelPlan& p1, int rows) {
  const int a = rows * p2.rs, b = p1.rs;
  return ((a > b ? a : b) + 3) & ~3;
}

// The tables, then one buffer of two planes, or two: with a dense stage, and
// on the ring.
__host__ __device__ inline int smem_bytes(const LevelPlan& p2,
                                          const LevelPlan& p1, int rows,
                                          bool ring) {
  const int nbuf = ring || p2.nbuf > 1 || p1.nbuf > 1 ? 2 : 1;
  return static_cast<int>(sizeof(float)) *
         (((p2.tab_len + p1.tab_len + 3) & ~3) +
          2 * nbuf * buffer_plane(p2, p1, rows));
}

// The ring's copies.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 copies `count` floats of each input plane from element `base`
// into (dr, di): two bulk copies by the copy engine, which complete the
// transaction count of `bar`.  The threads' last reads and writes of the
// buffer were ordered before this by a block barrier; the proxy fence
// orders them before the copy engine's writes.
__device__ __forceinline__ void copy_rows(const float* xr, const float* xi,
                                          int64_t base, int count, float* dr,
                                          float* di, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  const uint32_t bytes = static_cast<uint32_t>(count) * sizeof(float);
  const uint32_t b = smem_u32(bar);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(2 * bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dr)), "l"(xr + base),
      "r"(bytes), "r"(b) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(di)), "l"(xi + base),
      "r"(bytes), "r"(b) : "memory");
}

// Every thread waits for the phase of `bar` of parity `parity` to complete:
// the row chunk has landed, and its bytes are visible.
__device__ __forceinline__ void wait_rows(uint64_t* bar, unsigned parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
}

// 16 bytes from global memory into shared memory, L2 only; the bytes past
// `bytes` (0 or 16) are zero.
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// Every thread copies its 16-byte pieces of the (n1, tc) tile of columns
// c0 .. c0 + width of the output (element `base` = (plane, 0, c0), rows n2
// apart), the columns from width on zero, in one commit group: with kCout
// the interleaved points into dr, point (i, c) the float2 at i * tc + c;
// else yr's into dr and yi's into di at i * tc + c.  The block's threads
// last read and wrote the buffer before a block barrier: the proxy fence
// orders that before the copies (the tile's own stores by other SMs are
// ordered once a plane, after the cluster barrier).
template <bool kCout>
__device__ __forceinline__ void copy_cols(const float* yr, const float* yi,
                                          int64_t base, int n1, int n2, int tc,
                                          int width, float* dr, float* di) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  constexpr int kPer = kCout ? 2 : 4;  // points a piece
  const int tp = tc / kPer;
  const int sh = __ffs(tp) - 1;
  for (int e = threadIdx.x; e < n1 * tp; e += blockDim.x) {
    const int c = (e & (tp - 1)) * kPer;
    const int bytes = c < width ? 16 : 0;
    const int64_t off =
        bytes ? base + static_cast<int64_t>(e >> sh) * n2 + c : base;
    if constexpr (kCout) {
      cp_async16(dr + 4 * e, reinterpret_cast<const float2*>(yr) + off,
                 bytes);
    } else {
      cp_async16(dr + 4 * e, yr + off, bytes);
      cp_async16(di + 4 * e, yi + off, bytes);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Every thread waits for its copies of the column tile, with `newer` (the
// next column tile's group committed after it) left in flight, and then for
// the block's: the tile is visible.
__device__ __forceinline__ void wait_cols(bool newer) {
  if (newer)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// The ring: the block's tiles in one sequence (the row chunks of a plane,
// the cluster barrier, the column tiles of the plane, the row chunks of the
// next plane, ...) through two buffers, (buf, + plane) and (buf + 2 plane,
// + 3 plane).  Before the levels of a tile the copy of the next one
// starts into the other buffer, except across the cluster barrier: the
// first column tile of a plane is read only after every row is written.
// A tile is computed where it lands: the first level reads the row chunk
// at the input's stride n2, or the interleaved column tile as float2, and
// writes its own layout in place (every thread has read its points before
// any writes).
template <int kLayout, bool kFixed>
__device__ __forceinline__ void ring_walk(
    const float* xr, const float* xi, float* yr, float* yi,
    const LevelPlan& plan2, const Level* lev2, const float* tb2,
    const LevelPlan& plan1, const Level* lev1, const float* tb1, int pre,
    int n1, int n2, int rows, int tc, float* buf, int plane,
    cg::cluster_group& cluster, int csize, int rank) {
  constexpr bool kCout = kLayout == kOutC;
  __shared__ uint64_t bar[2];  // a buffer's: its row chunk has landed
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_u32(bar + b)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barriers, levels and tables are ready
  const int64_t npts = static_cast<int64_t>(n1) * n2;
  const int pstep = gridDim.x / csize;
  const int rstep = csize * rows, cstep = csize * tc;
  const int r_first = rank * rows, c_first = rank * tc;
  int fill = 0, use = 0;  // the buffer of the next copy, of the next tile
  unsigned parity = 0;    // bit b: the phase of bar[b] waited for next
  auto copy_rows_of = [&](int64_t p, int r0) {
    float* d = buf + 2 * fill * plane;
    copy_rows(xr, xi, p * npts + static_cast<int64_t>(r0) * n2,
              min(rows, n1 - r0) * n2, d, d + plane, bar + fill);
    fill ^= 1;
  };
  auto copy_cols_of = [&](int64_t p, int c0) {
    float* d = buf + 2 * fill * plane;
    copy_cols<kCout>(yr, yi, p * npts + c0, n1, n2, tc, min(tc, n2 - c0), d,
                     d + plane);
    fill ^= 1;
  };
  int64_t p = blockIdx.x / csize;
  if (p < pre && r_first < n1) copy_rows_of(p, r_first);
  for (; p < pre; p += pstep) {
    const int64_t poff = p * npts;
    // the next plane has a row chunk for this block
    const bool more = p + pstep < pre && r_first < n1;
    // 1. rows
    for (int r0 = r_first; r0 < n1; r0 += rstep) {
      const int nr = min(rows, n1 - r0);
      const int64_t base = poff + static_cast<int64_t>(r0) * n2;
      __syncthreads();  // the buffer of the tile before is free
      if (r0 + rstep < n1) copy_rows_of(p, r0 + rstep);
      wait_rows(bar + use, (parity >> use) & 1);
      parity ^= 1u << use;
      float* ar = buf + 2 * use * plane;
      float* ai = ar + plane;
      use ^= 1;
      row_levels<kFixed>(plan2, lev2, tb2, ar, ai, nullptr, nullptr, n2, nr,
                         yr, yi, rows_map<kCout>(base, n2), ar, ai);
    }
    // 2. every row of the plane is written before any column is read, and
    //    the copies see the other SMs' generic stores
    __threadfence();
    cluster.sync();
    asm volatile("fence.proxy.async.global;" ::: "memory");
    if (c_first < n2)
      copy_cols_of(p, c_first);
    else if (more)
      copy_rows_of(p + pstep, r_first);
    // 3. columns, in place
    for (int c0 = c_first; c0 < n2; c0 += cstep) {
      const int width = min(tc, n2 - c0);
      const int64_t base = poff + c0;
      const bool newer = c0 + cstep < n2;
      __syncthreads();  // the buffer of the tile before is free
      if (newer)
        copy_cols_of(p, c0 + cstep);
      else if (more)
        copy_rows_of(p + pstep, r_first);
      wait_cols(newer);
      float* ar = buf + 2 * use * plane;
      float* ai = ar + plane;
      use ^= 1;
      col_levels<kFixed, kCout>(plan1, lev1, tb1, ar, ai, nullptr, nullptr,
                                n1, tc, yr, yi,
                                cols_map<kCout>(base, n2, width));
    }
  }
}

// yr, yi are written by the row pass and read back by other blocks of the
// cluster in the column pass: no __restrict__ and no read-only loads on them.
// kRing: the ring's walk (ring_walk), else every tile in turn.  kFixed: the
// levels of the plans compiled in (FixedRows, FixedCols), which the launch
// has checked against plan2 and plan1, else those of plan2 and plan1 read
// at run time.
template <int kLayout, bool kRing, bool kFixed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    c2c_2d_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* yr, float* yi, const float* __restrict__ tab,
                  const LevelPlan plan2, const LevelPlan plan1, int pre,
                  int n1, int n2, int rows, int tc) {
  constexpr bool kCout = kLayout == kOutC;
  static_assert(kLayout == 0 || kCout, "planes, or an interleaved output");
  if constexpr (kFixed) {
    n1 = n2 = kFixedN;
    rows = kFixedChunk;
    tc = FixedCols::tl;
  }
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

  if constexpr (!kFixed) {
    stage_levels(plan2, lev2);
    stage_levels(plan1, lev1);
  }
  const int tab_len = plan2.tab_len + plan1.tab_len;
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tb2[i] = tab[i];
  if constexpr (kRing) {
    ring_walk<kLayout, kFixed>(xr, xi, yr, yi, plan2, lev2, tb2, plan1, lev1,
                               tb1, pre, n1, n2, rows, tc, ar, plane, cluster,
                               csize, rank);
    return;
  }
  const bool vrow = aligned16(xr) && aligned16(xi) && n2 % 4 == 0 &&
                    plan2.rs % 4 == 0 &&
                    (kCout || (aligned16(yr) && aligned16(yi)));
  const bool vcol =
      kCout ? aligned16(yr) && n2 % 2 == 0 && tc % 2 == 0
            : aligned16(xr) && aligned16(xi) && aligned16(yr) &&
                  aligned16(yi) && n2 % 4 == 0 && tc % 4 == 0;
  // a first level of butterflies reads the rows from the input
  const bool direct = kFixed || plan2.lev[0].kind != 0;

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
      row_levels<kFixed>(plan2, lev2, tb2, ar, ai, br, bi, n2, nr, yr, yi,
                         rows_map<kCout>(base, n2), x0r, x0i);
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
      col_levels<kFixed, false>(plan1, lev1, tb1, ar, ai, br, bi, n1, tc, yr,
                                yi, cols_map<kCout>(base, n2, width));
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

// The kernel of a layout and form.
using Kernel = decltype(&c2c_2d_kernel<0, false, false>);
static Kernel kernel_of(int layout, int ring, int fixed) {
  static const Kernel forms[2][2][2] = {
      {{c2c_2d_kernel<0, false, false>, c2c_2d_kernel<0, false, true>},
       {c2c_2d_kernel<0, true, false>, c2c_2d_kernel<0, true, true>}},
      {{c2c_2d_kernel<kOutC, false, false>,
        c2c_2d_kernel<kOutC, false, true>},
       {c2c_2d_kernel<kOutC, true, false>,
        c2c_2d_kernel<kOutC, true, true>}}};
  return forms[layout == kOutC][ring != 0][fixed != 0];
}

// Does the host's level plan p equal the plan P compiled in?
template <class P>
static bool is_plan(const int* p) {
  if (p == nullptr || p[0] != P::plan[0]) return false;
  for (size_t i = 0; i < sizeof(P::plan) / sizeof(int); ++i)
    if (p[i] != P::plan[i]) return false;
  return true;
}

// Allow every form kMaxSmem bytes of dynamic shared memory on the current
// device and report how many clusters of kCluster blocks of `smem` bytes of
// the form (`ring`, `fixed`) the whole card runs at once.  Returns the CUDA
// error code, 0 on success.
extern "C" int c2c_2d_occupancy(int smem, int ring, int fixed,
                                int* clusters) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  for (int layout : {0, kOutC})
    for (int r : {0, 1})
      for (int f : {0, 1}) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel_of(layout, r, f),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
        if (err != cudaSuccess) return static_cast<int>(err);
      }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = make_config(kCluster, smem, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, kernel_of(0, ring, fixed), &cfg));
}

// Launch `grid` blocks (a multiple of kCluster) in clusters of kCluster on
// `stream`, with the host's level plans of the n2 schedule (tl = 1) and the
// n1 schedule (tl = tc), each 4 + 8 * nlev ints (stockham.level_plan).
// Returns the CUDA error code of the launch, 0 on success.  The caller
// checks shapes: pre >= 1, rows * n2 and n1 * tc within kTilePoints, tc a
// power of two, tab holding the n2 table (plan2's tab_len floats) and then
// the n1 table, smem as smem_bytes computes it, allowed by
// c2c_2d_occupancy.  `layout` is 0 (split planes) or kOutC (yr an
// interleaved complex output, yi unused).  `ring` 1 takes the ring, which
// needs plans with no dense stage, n2 and tc multiples of 4 and 16-byte
// aligned tensors (fused2d.ring_fits); it is refused otherwise.  `fixed`
// 1 takes the levels compiled in, which needs plan2 and plan1 equal to
// FixedRows' and FixedCols' on a 512 x 512 plane in chunks of kFixedChunk
// rows and tiles of 16 columns (fused2d.FIXED_PLANS); it is refused
// otherwise.
extern "C" int c2c_2d_launch(const float* xr, const float* xi, float* yr,
                             float* yi, const float* tab, const int* plan2,
                             const int* plan1, int pre, int n1, int n2,
                             int rows, int tc, int layout, int ring,
                             int fixed, int grid, int smem, void* stream) {
  LevelPlan p2, p1;
  if (!read_plan(plan2, 1, &p2) || !read_plan(plan1, tc, &p1) ||
      rows * n2 > kTilePoints || n1 * tc > kTilePoints || grid % kCluster ||
      smem != smem_bytes(p2, p1, rows, ring) || (tc & (tc - 1)) ||
      (layout != 0 && layout != kOutC) || (ring != 0 && ring != 1) ||
      (fixed != 0 && fixed != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ring && (p2.nbuf != 1 || p1.nbuf != 1 || n2 % 4 || tc % 4 ||
               !aligned16(xr) || !aligned16(xi) || !aligned16(yr) ||
               (layout != kOutC && !aligned16(yi))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fixed && (n1 != kFixedN || n2 != kFixedN || rows != kFixedChunk ||
                tc != FixedCols::tl || !is_plan<FixedRows>(plan2) ||
                !is_plan<FixedCols>(plan1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      make_config(grid, smem, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel_of(layout, ring, fixed),
                                       xr, xi, yr, yi, tab, p2, p1, pre, n1,
                                       n2, rows, tc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
