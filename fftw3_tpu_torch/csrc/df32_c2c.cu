// Batched 1-D complex128 c2c along the last axis in double-float arithmetic
// (K7): every value is an unevaluated sum hi + lo of two floats, and every
// add and multiply is an error-free transform.  Hand-written for Hopper
// (sm_90a).
//
// Replaces the fused Pallas TPU kernel of the reference package:
// fftw3_tpu/ops/df32.py, _kernel_df32 with its stage loop _df_stages and the
// butterflies _df_vpu_dft, reached through _make_call_df32 (alg "df32p").
// It computes what those compute, operation for operation: the same
// schedule of 2-3-5-smooth radix stages, each a p-point df butterfly DFT
// (radix-4/2/5/3 recursion with level twiddles), then the (p, q) stage
// twiddle as a df complex multiply, then the Stockham autosort permute.  It
// takes the float64 planes themselves: the hi/lo split happens on load
// (hi = (float)x, lo = (float)(x - hi)) and the recombination (double)hi +
// (double)lo on store, which is the reference builder's _run boundary, so
// HBM sees one pass per point.  The transform is unnormalized.
//
// No fused multiply-add may touch the error-free transforms: nvcc contracts
// a*b + c into an FMA by default (--fmad=true), which would turn Dekker's
// split inexact (about 1e-7 instead of 1e-15).  Every sum is written with
// __fadd_rn / __fsub_rn and every product with __fmul_rn, which nvcc never
// contracts; the one FMA is the exact product error e = fmaf(a, b, -p) of
// two_prod, exact where Dekker's form is and cheaper.  The kernel runs the
// twin's df operations on the same operands in the same order, so it equals
// ops/df32.py's df32_c2c_torch bit for bit.
//
// What bounds it on an H100: instruction issue.  A df add is 11 FP32
// instructions and a df multiply 9 (3 FMUL, 1 FFMA, 5 FADD), so a complex df
// add is 22 and a complex df multiply 58; the [64, 16] schedule issues 408.5
// FP32 instructions a point (ops/df32.py, kernel_instructions) against 32
// bytes of HBM traffic (16 in, 16 out): about 0.10 ms of FP32 issue against
// 0.08 ms of memory at (8192, 1024).  An SM partition issues one warp
// instruction a clock, whatever its kind, so every integer, shared-memory,
// load and conversion instruction takes a slot an FP32 one could have used.
// The first design spent about 920 such instructions a point at
// [64, 16] (tools/k7_ablation.py on its SASS): run-time divisions in every
// level, a digit_pos loop per point in the permute and the store, four
// scalar shared-memory words per point per level, six passes and barriers a
// row.  This design keeps the arithmetic and moves everything else out of
// the per-point path:
//
//  * The host plans the passes (ops/df32.py, k7_plan): each stage's
//    recursion levels in passes of one level or two (r1 * r2 <= 16 df
//    points, 64 floats, in registers).  A task of a pass holds the points
//    sb*m + j + inner*a + (m/r1)*b (a < r2, b < r1) of one column c of a
//    row: the first level's butterflies run over b, the second's over a, in
//    registers, with their level twiddles.  At [64, 16]: (4, 4), (4), (4, 4)
//    -- three passes, two barriers a tile besides the one between tiles.
//  * The permute costs no pass: a stage's last pass multiplies by the stage
//    twiddle and writes in place, in digit-reversed order; the next stage's
//    first pass reads its column from there (the position tables dp of the
//    plan: one int load a task), and the last stage's last pass stores the
//    float64 output in natural order from registers (the table rev: one int
//    load a task).  Every other per-point address is a task base plus a
//    constant multiple of a pass stride; a task's row, column and place come
//    from FastDiv multiplies, once a task.  No run-time division is left.
//  * One buffer in place, 16 bytes a point: a point is one float4 (rh, rl,
//    ih, il), one LDS.128 or STS.128.  A pass that reads one layout and
//    writes another (a later stage's first pass when it writes shared
//    memory) reads all its tasks into registers, synchronises, then writes.
//    The buffer's slots are swizzled (slot = e ^ ((e >> s1 ^ e >> s2) & 7),
//    the host's choice, k7_swizzle) so that the warps' 16-byte accesses hit
//    eight distinct bank groups: at [64, 16] every access of a tile is free
//    of conflicts.
//  * A block of 256 threads takes a tile of rows_per_block whole rows (4 at
//    n = 1024: 64 KB, above the 48 KB a block gets without opting in, so the
//    occupancy query allows kMaxSmem first); two blocks an SM, 128
//    registers a thread.  Tiles are walked with a grid stride, any batch
//    works with no padding, row offsets are 64-bit.
//  * One run-time form serves every schedule, instantiated per family of
//    pass kinds (fam_has): a body that inlines all eleven kinds spills 11
//    KB at 128 registers and runs no faster than the first design, one that
//    inlines the two kinds of power-of-4 stages runs [64, 16] in under half
//    its time.  The host picks the first family that holds every kind of
//    its plan (ops/df32.py, k7_family).
//  * Constants (stage twiddles, radix-3/5 coefficients, level twiddles) are
//    one table of float4 entries (rh, rl, ih, il), built on the host in
//    float64 and split exactly, read through the read-only cache: per stage,
//    the (p, q) stage twiddle at k1*q + j2 when q > 1; then per recursion
//    level, the radix-3 (5) coefficients w^1.. (2, 4 entries) and, when the
//    level's sub-blocks hold more than one butterfly, its twiddles for
//    k1 = 1..r-1 at (k1 - 1)*(m/r) + j2.
//
// Timing-only arms (tools/k7_ablation.py, chip_smoke.py phase 41) share the
// body of family 0: kNoTwiddle skips the level and stage twiddle
// multiplies, kSkeleton replaces each butterfly by a reversal of its
// registers (every load, pass, barrier, permute and store kept, no df
// arithmetic), kCopy only splits on load and recombines on store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham_bfly.cuh"

namespace fftw3_tpu_torch {
namespace {

using fftw3_tpu_torch::FastDiv;
using fftw3_tpu_torch::fast_div;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;
constexpr int kMaxPasses = 12;
// ints of the host's plan: a header (passes, s1, s2, int-table length),
// then kPassInts a pass in ops/df32.py's PASS_FIELDS order
constexpr int kHeadInts = 4;
constexpr int kPassInts = 21;
// a cap on any launch's shared memory (tiles of up to 10240 points), set
// once: the attribute is a cap
constexpr int kMaxSmem = 163840;

struct DfArm {
  static constexpr int kFull = 0, kNoTwiddle = 1, kSkeleton = 2, kCopy = 3;
};

// A double-float complex value.
struct DC {
  float rh, rl, ih, il;
};

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void fast_two_sum(float s, float e, float& h,
                                             float& l) {
  h = __fadd_rn(s, e);
  l = __fsub_rn(e, __fsub_rn(h, s));
}

// hi + lo of (ah + al) + (bh + bl)
__device__ __forceinline__ void df_add(float ah, float al, float bh,
                                       float bl, float& h, float& l) {
  float s, e;
  two_sum(ah, bh, s, e);
  fast_two_sum(s, __fadd_rn(e, __fadd_rn(al, bl)), h, l);
}

// hi + lo of (ah + al) * (bh + bl)
__device__ __forceinline__ void df_mul(float ah, float al, float bh,
                                       float bl, float& h, float& l) {
  const float p = __fmul_rn(ah, bh);
  const float e = fmaf(ah, bh, -p);  // exact: a*b - p is a float
  fast_two_sum(p, __fadd_rn(e, __fadd_rn(__fmul_rn(ah, bl),
                                         __fmul_rn(al, bh))), h, l);
}

__device__ __forceinline__ DC cadd(const DC& a, const DC& b) {
  DC o;
  df_add(a.rh, a.rl, b.rh, b.rl, o.rh, o.rl);
  df_add(a.ih, a.il, b.ih, b.il, o.ih, o.il);
  return o;
}

__device__ __forceinline__ DC csub(const DC& a, const DC& b) {
  DC o;
  df_add(a.rh, a.rl, -b.rh, -b.rl, o.rh, o.rl);
  df_add(a.ih, a.il, -b.ih, -b.il, o.ih, o.il);
  return o;
}

__device__ __forceinline__ DC cmul(const DC& a, const DC& b) {
  float rrh, rrl, iih, iil, rih, ril, irh, irl;
  df_mul(a.rh, a.rl, b.rh, b.rl, rrh, rrl);
  df_mul(a.ih, a.il, b.ih, b.il, iih, iil);
  df_mul(a.rh, a.rl, b.ih, b.il, rih, ril);
  df_mul(a.ih, a.il, b.rh, b.rl, irh, irl);
  DC o;
  df_add(rrh, rrl, -iih, -iil, o.rh, o.rl);
  df_add(rih, ril, irh, irl, o.ih, o.il);
  return o;
}

// a * (i*sign)
__device__ __forceinline__ DC imul(const DC& a, int sign) {
  if (sign < 0) return DC{a.ih, a.il, -a.rh, -a.rl};
  return DC{-a.ih, -a.il, a.rh, a.rl};
}

// Entry i of the constant table.
__device__ __forceinline__ DC entry(const float4* __restrict__ tab, int i) {
  const float4 v = __ldg(tab + i);
  return DC{v.x, v.y, v.z, v.w};
}

// The R-point df butterfly on x[0..R), in place: the reference's
// _df_vpu_dft body for one point of every column.  `cf` holds the radix-3/5
// coefficients w^1.. (R - 1 entries).
template <int R>
__device__ __forceinline__ void dft(DC (&x)[R], int sign,
                                    const float4* __restrict__ cf) {
  if constexpr (R == 2) {
    const DC b0 = cadd(x[0], x[1]);
    const DC b1 = csub(x[0], x[1]);
    x[0] = b0;
    x[1] = b1;
  } else if constexpr (R == 4) {
    const DC t0 = cadd(x[0], x[2]);
    const DC t1 = csub(x[0], x[2]);
    const DC t2 = cadd(x[1], x[3]);
    const DC u3 = imul(csub(x[1], x[3]), sign);
    x[0] = cadd(t0, t2);
    x[1] = cadd(t1, u3);
    x[2] = csub(t0, t2);
    x[3] = csub(t1, u3);
  } else if constexpr (R == 3) {
    const DC w1 = entry(cf, 0), w2 = entry(cf, 1);
    const DC b0 = cadd(x[0], cadd(x[1], x[2]));
    const DC b1 = cadd(x[0], cadd(cmul(x[1], w1), cmul(x[2], w2)));
    const DC b2 = cadd(x[0], cadd(cmul(x[1], w2), cmul(x[2], w1)));
    x[0] = b0;
    x[1] = b1;
    x[2] = b2;
  } else {
    static_assert(R == 5, "butterflies of 2, 3, 4 and 5 points");
    DC w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = entry(cf, k);
    DC b[5];
#pragma unroll
    for (int k1 = 0; k1 < 5; ++k1) {  // the direct coefficient form
      DC acc = x[0];
#pragma unroll
      for (int j1 = 1; j1 < 5; ++j1)
        acc = cadd(acc, k1 == 0 ? x[j1] : cmul(x[j1], w[(j1 * k1) % 5 - 1]));
      b[k1] = acc;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) x[k] = b[k];
  }
}

// The butterfly of an arm: the skeleton reverses its registers instead (a
// renaming, no instruction), so the stores still move other values.
template <int R, int kArm>
__device__ __forceinline__ void butterfly(DC (&x)[R], int sign,
                                          const float4* __restrict__ cf) {
  if constexpr (kArm == DfArm::kSkeleton) {
    DC t[R];
#pragma unroll
    for (int k = 0; k < R; ++k) t[k] = x[(R - k) % R];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = t[k];
  } else {
    dft<R>(x, sign, cf);
  }
}

// A pass of the host's plan (PASS_FIELDS in ops/df32.py), then what
// read_plan derives from it.
struct Pass {
  int r1, r2, src, dst, m, inner, S, done, q, p, cf1, lt1, cf2, lt2, stw,
      rev, dp, sp, donep, ustride, mid;
  int mr1;  // m / r1
  int tpr;  // tasks of one row, n / (r1 r2)
  int pm;   // p / m, the output-index step of the first level's digit
  FastDiv f_tpr, f_S, f_inner, f_done, f_donep;
};

struct Plan {
  int npass, s1, s2;
  Pass ps[kMaxPasses];
};

// Tasks a thread runs at once in a pass of r1 * r2 points (ops/df32.py,
// _pass_tasks).
__host__ __device__ constexpr int unroll(int pts) {
  return pts >= 16 ? 1 : 16 / pts;
}

// The buffer slot of tile point e.
__device__ __forceinline__ int slot(int e, int s1, int s2) {
  return e ^ (((e >> s1) ^ (e >> s2)) & 7);
}

// What every pass of a tile shares.
struct Tile {
  const double* xr;
  const double* xi;
  double* yr;
  double* yi;
  const float4* tab;
  const int* itab;
  float4* buf;
  int64_t goff;  // the tile's first point in the planes
  int nrows, n, sign, s1, s2;
};

// Row, column, sub-block and inner index of task w.
struct Task {
  int row, c, sb, j;
  __device__ __forceinline__ Task(const Pass& P, int w) {
    row = P.f_tpr.div(w);
    const int u = w - row * P.tpr;
    const int v = P.f_S.div(u);
    c = u - v * P.S;
    sb = P.f_inner.div(v);
    j = v - sb * P.inner;
  }
  // the tile point of the task's register (a, b) in its stage's layout
  __device__ __forceinline__ int point(const Pass& P, int n) const {
    return row * n + (sb * P.m + j) * P.S + c;
  }
};

// One pass of levels (R1, R2) over every task of the tile: tasks w = tid +
// kThreads * (round * U + u), U of them at once.  Reads every point of the
// round's tasks into registers (from the float64 input, the buffer in
// place, or the previous stage's digit-reversed layout), synchronises when
// the pass writes another layout than it read, then runs the levels and
// writes (the buffer in place, or the float64 output in natural order).
template <int R1, int R2, int kArm>
__device__ __forceinline__ void run_pass(const Pass P, const Tile& T) {
  constexpr int U = unroll(R1 * R2);
  const int total = T.nrows * P.tpr;
  const int rounds = P.mid ? 1 : (total + kThreads * U - 1) / (kThreads * U);
  const int sa = P.inner * P.S, sbs = P.mr1 * P.S;  // in-place strides
  for (int rd = 0; rd < rounds; ++rd) {
    DC x[U][R2][R1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = (rd * U + u) * kThreads + threadIdx.x;
      if (w >= total) continue;
      const Task t(P, w);
      if (P.src == 0) {
        const int64_t e0 = T.goff + t.point(P, T.n);
#pragma unroll
        for (int a = 0; a < R2; ++a)
#pragma unroll
          for (int b = 0; b < R1; ++b) {
            const int64_t e = e0 + a * sa + b * sbs;
            const double vr = T.xr[e], vi = T.xi[e];
            const float rh = __double2float_rn(vr);
            const float ih = __double2float_rn(vi);
            x[u][a][b] = DC{
                rh, __double2float_rn(__dsub_rn(vr, static_cast<double>(rh))),
                ih, __double2float_rn(__dsub_rn(vi, static_cast<double>(ih)))};
          }
      } else {
        int e0, ea, eb;
        if (P.src == 1) {
          e0 = t.point(P, T.n);
          ea = sa;
          eb = sbs;
        } else {  // the previous stage's output k1 of column (j2, d)
          const int j2s = P.f_done.div(t.c);
          const int ds = t.c - j2s * P.done;
          const int k1 = P.f_donep.div(ds);
          const int d = ds - k1 * P.donep;
          e0 = t.row * T.n + __ldg(T.itab + P.dp + k1) * P.sp +
               j2s * P.donep + d + (t.sb * P.m + t.j) * P.ustride;
          ea = P.inner * P.ustride;
          eb = P.mr1 * P.ustride;
        }
#pragma unroll
        for (int a = 0; a < R2; ++a)
#pragma unroll
          for (int b = 0; b < R1; ++b) {
            const float4 v = T.buf[slot(e0 + a * ea + b * eb, T.s1, T.s2)];
            x[u][a][b] = DC{v.x, v.y, v.z, v.w};
          }
      }
    }
    if (P.mid) __syncthreads();  // every read of the pass is done
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = (rd * U + u) * kThreads + threadIdx.x;
      if (w >= total) continue;
      const Task t(P, w);
      // the first level, over b, then its twiddles
#pragma unroll
      for (int a = 0; a < R2; ++a) {
        butterfly<R1, kArm>(x[u][a], T.sign, T.tab + P.cf1);
        if (kArm == DfArm::kFull && P.lt1 >= 0) {
          const int i0 = P.lt1 + t.j + P.inner * a;
#pragma unroll
          for (int b = 1; b < R1; ++b)
            x[u][a][b] = cmul(x[u][a][b], entry(T.tab, i0 + (b - 1) * P.mr1));
        }
      }
      // the second level, over a, then its twiddles
      if constexpr (R2 > 1) {
#pragma unroll
        for (int b = 0; b < R1; ++b) {
          DC z[R2];
#pragma unroll
          for (int a = 0; a < R2; ++a) z[a] = x[u][a][b];
          butterfly<R2, kArm>(z, T.sign, T.tab + P.cf2);
          if (kArm == DfArm::kFull && P.lt2 >= 0) {
#pragma unroll
            for (int a = 1; a < R2; ++a)
              z[a] = cmul(z[a], entry(T.tab, P.lt2 + t.j + (a - 1) * P.inner));
          }
#pragma unroll
          for (int a = 0; a < R2; ++a) x[u][a][b] = z[a];
        }
      }
      // the output index of register (a, b) in the stage's last pass:
      // k0 + b * pm + a * R1 * pm
      int k0 = 0;
      if (P.stw >= 0 || P.dst == 1) k0 = __ldg(T.itab + P.rev + t.sb * P.m);
      if (kArm == DfArm::kFull && P.stw >= 0) {
        const int i0 = P.stw + k0 * P.q + P.f_done.div(t.c);
#pragma unroll
        for (int a = 0; a < R2; ++a)
#pragma unroll
          for (int b = 0; b < R1; ++b)
            x[u][a][b] = cmul(x[u][a][b],
                              entry(T.tab, i0 + (b + a * R1) * P.pm * P.q));
      }
      if (P.dst == 1) {
        const int64_t e0 =
            T.goff + t.row * T.n + k0 * P.done + t.c;
#pragma unroll
        for (int a = 0; a < R2; ++a)
#pragma unroll
          for (int b = 0; b < R1; ++b) {
            const int64_t e = e0 + (b + a * R1) * P.pm * P.done;
            const DC& v = x[u][a][b];
            T.yr[e] = __dadd_rn(static_cast<double>(v.rh),
                                static_cast<double>(v.rl));
            T.yi[e] = __dadd_rn(static_cast<double>(v.ih),
                                static_cast<double>(v.il));
          }
      } else {
        const int e0 = t.point(P, T.n);
#pragma unroll
        for (int a = 0; a < R2; ++a)
#pragma unroll
          for (int b = 0; b < R1; ++b) {
            const DC& v = x[u][a][b];
            T.buf[slot(e0 + a * sa + b * sbs, T.s1, T.s2)] =
                make_float4(v.rh, v.rl, v.ih, v.il);
          }
      }
    }
  }
}

// The pass kinds (r1, r2) the kernel runs.
__host__ __device__ constexpr bool kind_ok(int r1, int r2) {
  return (r1 == 4 && (r2 == 4 || r2 == 2 || r2 == 3 || r2 == 1)) ||
         (r1 == 2 && (r2 == 5 || r2 == 3 || r2 == 1)) ||
         (r1 == 5 && (r2 == 3 || r2 == 1)) || (r1 == 3 && (r2 == 3 || r2 == 1));
}

// The kinds family kFam inlines (ops/df32.py, K7_FAMILIES): (4, 4) with
// (4, 1), (2, 1) or (4, 2) -- the df32p schedules of n = 1024, 512, 256 and
// 128 -- then every kind.  One body that inlines every kind takes 128
// registers and spills 11 KB, and runs [64, 16] no faster than the first
// design (0.61-0.64 ms); the same body with family 0's two kinds runs it
// in 0.28-0.29 ms (PERF.md).
template <int kFam>
__host__ __device__ constexpr bool fam_has(int r1, int r2) {
  return kFam == 3 ? kind_ok(r1, r2)
                   : (r1 == 4 && r2 == 4) ||
                         (kFam == 0 && r1 == 4 && r2 == 1) ||
                         (kFam == 1 && r1 == 2 && r2 == 1) ||
                         (kFam == 2 && r1 == 4 && r2 == 2);
}

// Pass kind (R1, R2) when family kFam holds it.
template <int R1, int R2, int kArm, int kFam>
__device__ __forceinline__ void pass_if(const Pass& P, const Tile& T) {
  if constexpr (fam_has<kFam>(R1, R2)) run_pass<R1, R2, kArm>(P, T);
}

template <int kArm, int kFam>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
df32_c2c_kernel(const double* __restrict__ xr, const double* __restrict__ xi,
                double* __restrict__ yr, double* __restrict__ yi,
                const float4* __restrict__ tab, const int* __restrict__ itab,
                const Plan plan, int rows, int n, int rpb, int sign) {
  extern __shared__ float4 buf[];
  __shared__ Pass pl[kMaxPasses];
  // the passes in shared memory, where a pass is read at a run-time index
  // (a kernel parameter read so is copied to local memory)
#pragma unroll
  for (int l = 0; l < kMaxPasses; ++l)
    if (static_cast<int>(threadIdx.x) == l && l < plan.npass)
      pl[l] = plan.ps[l];
  __syncthreads();
  const int ntiles = (rows + rpb - 1) / rpb;
  for (int tix = blockIdx.x; tix < ntiles; tix += gridDim.x) {
    const int row0 = tix * rpb;
    const int nrows = min(rpb, rows - row0);
    const int64_t goff = static_cast<int64_t>(row0) * n;
    if constexpr (kArm == DfArm::kCopy) {
      for (int i = threadIdx.x; i < nrows * n; i += kThreads) {
        const double a = xr[goff + i], b = xi[goff + i];
        const float ah = __double2float_rn(a), bh = __double2float_rn(b);
        const float al = __double2float_rn(__dsub_rn(a, double(ah)));
        const float bl = __double2float_rn(__dsub_rn(b, double(bh)));
        yr[goff + i] = __dadd_rn(double(ah), double(al));
        yi[goff + i] = __dadd_rn(double(bh), double(bl));
      }
    } else {
      const Tile T{xr, xi, yr, yi, tab, itab, buf, goff, nrows, n, sign,
                   plan.s1, plan.s2};
      __syncthreads();  // the previous tile's last pass has read the buffer
      for (int pi = 0; pi < plan.npass; ++pi) {
        const Pass P = pl[pi];
        switch (P.r1 * 8 + P.r2) {
          case 4 * 8 + 4: pass_if<4, 4, kArm, kFam>(P, T); break;
          case 4 * 8 + 2: pass_if<4, 2, kArm, kFam>(P, T); break;
          case 4 * 8 + 3: pass_if<4, 3, kArm, kFam>(P, T); break;
          case 2 * 8 + 5: pass_if<2, 5, kArm, kFam>(P, T); break;
          case 2 * 8 + 3: pass_if<2, 3, kArm, kFam>(P, T); break;
          case 5 * 8 + 3: pass_if<5, 3, kArm, kFam>(P, T); break;
          case 3 * 8 + 3: pass_if<3, 3, kArm, kFam>(P, T); break;
          case 4 * 8 + 1: pass_if<4, 1, kArm, kFam>(P, T); break;
          case 2 * 8 + 1: pass_if<2, 1, kArm, kFam>(P, T); break;
          case 5 * 8 + 1: pass_if<5, 1, kArm, kFam>(P, T); break;
          default: pass_if<3, 1, kArm, kFam>(P, T); break;
        }
        if (P.dst == 0) __syncthreads();  // the next pass reads other tasks'
      }
    }
  }
}

// Reads the host's plan (ops/df32.py, k7_plan_array) for rows of n points
// and tiles of rpb rows; false when it does not fit the kernel of family
// kFam.
template <int kFam>
bool read_plan(const int* p, int n, int rpb, Plan* out) {
  if (p == nullptr || p[0] < 1 || p[0] > kMaxPasses || n < 2 || rpb < 1 ||
      p[1] < 3 || p[2] < 3 || p[1] > 31 || p[2] > 31)
    return false;
  *out = Plan{};
  out->npass = p[0];
  out->s1 = p[1];
  out->s2 = p[2];
  const int nint = p[3];  // the int tables' length
  for (int l = 0; l < out->npass; ++l) {
    const int* v = p + kHeadInts + kPassInts * l;
    Pass& P = out->ps[l];
    P = Pass{v[0],  v[1],  v[2],  v[3],  v[4],  v[5],  v[6],
             v[7],  v[8],  v[9],  v[10], v[11], v[12], v[13],
             v[14], v[15], v[16], v[17], v[18], v[19], v[20]};
    const int pts = P.r1 * P.r2;
    if (!fam_has<kFam>(P.r1, P.r2) || P.m < pts || P.m % pts || n % pts ||
        P.inner != P.m / pts || P.S < 1 || P.done < 1 || P.donep < 1 ||
        P.q < 1 || P.p % P.m || P.src < 0 || P.src > 2 || P.dst < 0 ||
        P.dst > 1 || P.rev < 0 || P.rev + P.p > nint || P.dp < 0 ||
        (P.src == 2 && P.dp >= nint) ||
        (P.mid && rpb * (n / pts) > kThreads * unroll(pts)))
      return false;
    P.mr1 = P.m / P.r1;
    P.tpr = n / pts;
    P.pm = P.p / P.m;
    P.f_tpr = fast_div(P.tpr);
    P.f_S = fast_div(P.S);
    P.f_inner = fast_div(P.inner);
    P.f_done = fast_div(P.done);
    P.f_donep = fast_div(P.donep);
  }
  return true;
}

// Shared-memory bytes of a launch (ops/df32.py, k7_smem): one buffer of 16
// bytes a point for rpb rows, a whole number of eight-slot groups.
inline int smem_bytes(int n, int rpb) {
  return 16 * ((rpb * n + 7) / 8 * 8);
}

template <int kArm, int kFam>
int occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      df32_c2c_kernel<kArm, kFam>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, df32_c2c_kernel<kArm, kFam>, kThreads,
      static_cast<size_t>(smem)));
}

template <int kArm, int kFam>
int launch(const double* xr, const double* xi, double* yr, double* yi,
           const float* tab, const int* itab, const int* plan, int rows,
           int n, int rpb, int sign, int grid, int smem, void* stream) {
  Plan p;
  if (rows < 1 || (sign != 1 && sign != -1) ||
      !read_plan<kFam>(plan, n, rpb, &p) || smem != smem_bytes(n, rpb) ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  df32_c2c_kernel<kArm, kFam><<<grid, kThreads, static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, reinterpret_cast<const float4*>(tab), itab, p, rows, n,
      rpb, sign);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// Every entry point acts on the caller's current device; the caller sets
// it.  <name>_occupancy(smem, blocks_per_sm) allows the kernel kMaxSmem
// bytes of dynamic shared memory on the current device and reports how many
// blocks of `smem` bytes fit on one SM; <name>_launch(xr, xi, yr, yi, tab,
// itab, plan, rows, n, rpb, sign, grid, smem, stream) launches `grid` blocks
// on `stream` (a cudaStream_t passed as a pointer).  Each returns the CUDA
// error code, 0 on success.  The caller checks shapes: rows >= 1 rows of n
// points; `plan` the host's plan of the schedule (ops/df32.py,
// k7_plan_array), every pass kind in the entry point's family; `tab` its
// constant table of sign `sign` (16-byte aligned) and `itab` its int tables
// on the card; rpb rows a tile, smem = 16 * rpb * n bytes rounded up to 128,
// allowed by the occupancy call.
//
// K7: df32_c2c_f<family>.  The timing-only arms: df32_ablate<arm>, family 0
// (arm 0 is K7's own kernel).
#define DF32_ENTRY(NAME, ARM, FAM)                                            \
  extern "C" int NAME##_occupancy(int smem, int* blocks_per_sm) {             \
    return occupancy<ARM, FAM>(smem, blocks_per_sm);                          \
  }                                                                           \
  extern "C" int NAME##_launch(                                               \
      const double* xr, const double* xi, double* yr, double* yi,             \
      const float* tab, const int* itab, const int* plan, int rows, int n,    \
      int rpb, int sign, int grid, int smem, void* stream) {                  \
    return launch<ARM, FAM>(xr, xi, yr, yi, tab, itab, plan, rows, n, rpb,    \
                            sign, grid, smem, stream);                        \
  }
DF32_ENTRY(df32_c2c_f0, DfArm::kFull, 0)
DF32_ENTRY(df32_c2c_f1, DfArm::kFull, 1)
DF32_ENTRY(df32_c2c_f2, DfArm::kFull, 2)
DF32_ENTRY(df32_c2c_f3, DfArm::kFull, 3)
DF32_ENTRY(df32_ablate0, DfArm::kFull, 0)
DF32_ENTRY(df32_ablate1, DfArm::kNoTwiddle, 0)
DF32_ENTRY(df32_ablate2, DfArm::kSkeleton, 0)
DF32_ENTRY(df32_ablate3, DfArm::kCopy, 0)
