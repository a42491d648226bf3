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
// two_prod, exact where Dekker's form is and cheaper.
//
// What bounds it on an H100: the arithmetic.  A df add here is 11 FP32
// instructions and a df multiply 9 (3 FMUL, 1 FFMA, 5 FADD), so a complex
// df add is 22 and a complex df multiply 58; the [64, 16] schedule issues
// 408.5 per point (ops/df32.py, kernel_instructions) against 32 bytes of
// HBM traffic (16 in, 16 out): about 0.10 ms of FP32 instructions against
// 0.08 ms of memory at (8192, 1024).  The design keeps every intermediate
// on chip: a block holds its rows' four float planes in shared memory
// through every stage (one HBM read and one write per point).  The simple
// form comes first: each level of each butterfly recursion is one pass in
// which a thread computes one radix-r df butterfly in registers, in place,
// then the block synchronises; no tensor cores, no TMA.
//
// Layout and schedule:
//  * A block takes a tile of rpb whole rows (the caller's choice,
//    ops/df32.py rows_per_block) and walks the tiles with a grid stride, so
//    any batch works with no padding; row offsets are 64-bit.  256 threads:
//    one radix-4 butterfly each at n = 1024.
//  * Shared memory: two buffers (A, B) of four planes (rh, rl, ih, il) of
//    rpb * n floats, 32 bytes per point in all.
//  * A stage (p, q, done) sees a row as (p, q, done), column c = j2*done + d,
//    stride S = q*done.  Its p-point DFT runs in place on every column as a
//    decimation-in-frequency recursion: level l combines r points at
//    distance m_l/r inside each sub-block of m_l, applies the level
//    twiddle, and writes the r results back where it read them, so the
//    column ends in digit-reversed order (digit_pos).  The twiddle-and-
//    permute pass then reads X[k1] of column (j2, d) from its digit-
//    reversed place, multiplies by w[k1, j2] and writes point
//    (j2*p + k1)*done + d of the other buffer.  The last stage (q = 1) has
//    neither: the store reads its digit-reversed places directly.
//  * Constants (stage twiddles, radix-3/5 coefficients, level twiddles) are
//    one float table built on the host in float64 and split exactly into
//    (hi, lo) pairs, read through the read-only cache.  Layout, stage by
//    stage: the (p, q) stage twiddle as four p*q planes (rh, rl, ih, il)
//    when q > 1; then the butterfly stream of the p-point DFT, per
//    recursion level: for radix 3 (5) the 2 (4) coefficients w^1.. as four
//    floats each, then, when m/r > 1, the level twiddles for k1 = 1..r-1 as
//    four planes of m/r floats each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStages = 4;

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

// A df complex constant from four consecutive floats (rh, rl, ih, il).
__device__ __forceinline__ DC coeff(const float* __restrict__ t) {
  return DC{__ldg(t), __ldg(t + 1), __ldg(t + 2), __ldg(t + 3)};
}

// Entry j of a constant stored as four planes of `len` floats.
__device__ __forceinline__ DC planes_at(const float* __restrict__ t, int len,
                                        int j) {
  return DC{__ldg(t + j), __ldg(t + len + j), __ldg(t + 2 * len + j),
            __ldg(t + 3 * len + j)};
}

__device__ __forceinline__ int radix_of(int m) {
  if (m % 4 == 0) return 4;
  if (m % 2 == 0) return 2;
  if (m % 5 == 0) return 5;
  return 3;
}

// Where the in-place recursion leaves X[k] of an m-point column: digit k1 of
// the first level (k = k1 + r*k2) selects the sub-block k1*(m/r), the child
// places k2 inside it.
__device__ __forceinline__ int digit_pos(int k, int m) {
  int pos = 0;
  while (m > 1) {
    const int r = radix_of(m);
    const int q = m / r;
    pos += (k % r) * q;
    k /= r;
    m = q;
  }
  return pos;
}

// The four float planes of one buffer.
struct Planes {
  float *rh, *rl, *ih, *il;
  __device__ __forceinline__ DC get(int i) const {
    return DC{rh[i], rl[i], ih[i], il[i]};
  }
  __device__ __forceinline__ void put(int i, const DC& v) const {
    rh[i] = v.rh;
    rl[i] = v.rl;
    ih[i] = v.ih;
    il[i] = v.il;
  }
};

// One radix-R df butterfly on x[0..R): the reference's _df_vpu_dft body
// for one point of every (j2, column), then the level twiddle of outputs
// k1 > 0 (lt = the level's twiddle planes of qq floats, nullptr when
// qq == 1).  `cf` holds the radix-3/5 coefficients.
template <int R>
__device__ __forceinline__ void butterfly(DC* x, int sign,
                                          const float* __restrict__ cf,
                                          const float* __restrict__ lt,
                                          int qq, int j2) {
  DC b[R];
  if (R == 2) {
    b[0] = cadd(x[0], x[1]);
    b[1] = csub(x[0], x[1]);
  } else if (R == 4) {
    const DC t0 = cadd(x[0], x[2]);
    const DC t1 = csub(x[0], x[2]);
    const DC t2 = cadd(x[1], x[3]);
    const DC u3 = imul(csub(x[1], x[3]), sign);
    b[0] = cadd(t0, t2);
    b[1] = cadd(t1, u3);
    b[2] = csub(t0, t2);
    b[3] = csub(t1, u3);
  } else if (R == 3) {
    const DC w1 = coeff(cf), w2 = coeff(cf + 4);
    b[0] = cadd(x[0], cadd(x[1], x[2]));
    b[1] = cadd(x[0], cadd(cmul(x[1], w1), cmul(x[2], w2)));
    b[2] = cadd(x[0], cadd(cmul(x[1], w2), cmul(x[2], w1)));
  } else {  // R == 5: the direct coefficient form, w^1..w^4
#pragma unroll
    for (int k1 = 0; k1 < 5; ++k1) {
      DC acc = x[0];
#pragma unroll
      for (int j1 = 1; j1 < 5; ++j1) {
        if (k1 == 0)
          acc = cadd(acc, x[j1]);
        else
          acc = cadd(acc, cmul(x[j1], coeff(cf + 4 * ((j1 * k1) % 5 - 1))));
      }
      b[k1] = acc;
    }
  }
  x[0] = b[0];
#pragma unroll
  for (int k1 = 1; k1 < R; ++k1)
    x[k1] = lt ? cmul(b[k1], planes_at(lt + 4 * (k1 - 1) * qq, qq, j2))
               : b[k1];
}

// One level of the in-place recursion over every column of the tile:
// butterflies of radix R inside sub-blocks of m points (m = R*qq) of the
// p-point columns at stride S.
template <int R>
__device__ __forceinline__ void level(const Planes& buf, int rows, int n,
                                      int S, int m, int qq, int sign,
                                      const float* __restrict__ cf,
                                      const float* __restrict__ lt) {
  const int per_row = n / R;
  const int total = rows * per_row;
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    const int row = w / per_row;
    const int b = w - row * per_row;
    const int t = b / S;
    const int c = b - t * S;
    const int sb = t / qq;
    const int j2 = t - sb * qq;
    const int base = row * n + (sb * m + j2) * S + c;
    const int stride = qq * S;
    DC x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = buf.get(base + j * stride);
    butterfly<R>(x, sign, cf, lt, qq, j2);
#pragma unroll
    for (int j = 0; j < R; ++j) buf.put(base + j * stride, x[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
df32_c2c_kernel(const double* __restrict__ xr, const double* __restrict__ xi,
                double* __restrict__ yr, double* __restrict__ yi,
                const float* __restrict__ tab, int rows, int n, int nstages,
                int4 radices, int rpb, int sign) {
  extern __shared__ float smem[];
  const int tile = rpb * n;
  const Planes A{smem, smem + tile, smem + 2 * tile, smem + 3 * tile};
  const Planes B{smem + 4 * tile, smem + 5 * tile, smem + 6 * tile,
                 smem + 7 * tile};
  const int prad[kMaxStages] = {radices.x, radices.y, radices.z, radices.w};
  const int ntiles = (rows + rpb - 1) / rpb;
  for (int tix = blockIdx.x; tix < ntiles; tix += gridDim.x) {
    const int row0 = tix * rpb;
    const int nrows = min(rpb, rows - row0);
    const int64_t goff = static_cast<int64_t>(row0) * n;
    __syncthreads();  // the previous tile's store has read its buffer
    for (int i = threadIdx.x; i < nrows * n; i += blockDim.x) {
      const double a = xr[goff + i];
      const double b = xi[goff + i];
      const float ah = __double2float_rn(a);
      const float bh = __double2float_rn(b);
      A.rh[i] = ah;
      A.rl[i] = __double2float_rn(__dsub_rn(a, static_cast<double>(ah)));
      A.ih[i] = bh;
      A.il[i] = __double2float_rn(__dsub_rn(b, static_cast<double>(bh)));
    }
    __syncthreads();
    Planes cur = A, oth = B;
    int off = 0, rest = n, done = 1;
    for (int s = 0; s < nstages; ++s) {
      const int p = prad[s];
      const int q = rest / p;
      const int S = q * done;
      const int tw = off;
      if (q > 1) off += 4 * p * q;
      for (int m = p; m > 1;) {
        const int r = radix_of(m);
        const int qq = m / r;
        const float* cf = tab + off;
        off += r == 3 ? 8 : r == 5 ? 16 : 0;
        const float* lt = qq > 1 ? tab + off : nullptr;
        if (qq > 1) off += 4 * (r - 1) * qq;
        if (r == 4)
          level<4>(cur, nrows, n, S, m, qq, sign, cf, lt);
        else if (r == 2)
          level<2>(cur, nrows, n, S, m, qq, sign, cf, lt);
        else if (r == 5)
          level<5>(cur, nrows, n, S, m, qq, sign, cf, lt);
        else
          level<3>(cur, nrows, n, S, m, qq, sign, cf, lt);
        __syncthreads();
        m = qq;
      }
      if (q > 1) {
        // stage twiddle and autosort permute: cur -> oth
        for (int w = threadIdx.x; w < nrows * n; w += blockDim.x) {
          const int row = w / n;
          const int o = w - row * n;  // (j2*p + k1)*done + d
          const int t = o / done;
          const int d = o - t * done;
          const int j2 = t / p;
          const int k1 = t - j2 * p;
          const DC v = cur.get(row * n + digit_pos(k1, p) * S + j2 * done + d);
          oth.put(w, cmul(v, planes_at(tab + tw, p * q, k1 * q + j2)));
        }
        __syncthreads();
        const Planes tmp = cur;
        cur = oth;
        oth = tmp;
      }
      done *= p;
      rest = q;
    }
    // the last stage's points, from their digit-reversed places
    const int pl = prad[nstages - 1];
    const int dl = n / pl;
    for (int w = threadIdx.x; w < nrows * n; w += blockDim.x) {
      const int row = w / n;
      const int o = w - row * n;  // k1*dl + d
      const int k1 = o / dl;
      const int src = row * n + digit_pos(k1, pl) * dl + (o - k1 * dl);
      yr[goff + w] = __dadd_rn(static_cast<double>(cur.rh[src]),
                               static_cast<double>(cur.rl[src]));
      yi[goff + w] = __dadd_rn(static_cast<double>(cur.ih[src]),
                               static_cast<double>(cur.il[src]));
    }
  }
}

}  // namespace

// Both entry points act on the caller's current device; the caller sets it.

// The most dynamic shared memory a launch gets without opting in; the
// caller's tile (ops/df32.py, TILE_POINTS) keeps under it.
constexpr int kMaxSmem = 48 * 1024;

// Report how many blocks of `smem` bytes fit on one SM.  Returns the CUDA
// error code, 0 on success.
extern "C" int df32_c2c_occupancy(int smem, int* blocks_per_sm) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, df32_c2c_kernel, kThreads, static_cast<size_t>(smem)));
}

// Launch `grid` blocks on `stream` (a cudaStream_t passed as a pointer).
// Returns the CUDA error code of the launch, 0 on success.  The caller
// checks shapes: rows >= 1; 1 <= nstages <= 4 radices p0..p3 (unused ones
// 1), each 2-3-5-smooth, whose product is n; rpb rows per block tile;
// smem = 32 * rpb * n bytes, at most kMaxSmem; `tab` the constant table of
// this schedule and `sign` (layout at the top of this file).
extern "C" int df32_c2c_launch(const double* xr, const double* xi, double* yr,
                               double* yi, const float* tab, int rows, int n,
                               int nstages, int p0, int p1, int p2, int p3,
                               int rpb, int sign, int grid, int smem,
                               void* stream) {
  if (nstages < 1 || nstages > kMaxStages || smem != 32 * rpb * n ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  df32_c2c_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, tab, rows, n, nstages, make_int4(p0, p1, p2, p3), rpb,
      sign);
  return static_cast<int>(cudaGetLastError());
}
