// The register butterfly stage of K1 (stockham_c2c.cu), K2 (inner_c2c.cu),
// K3 (c2c_2d.cu), K4 (r2c.cu), K5 (r2c_inner.cu) and K6 (c2r.cu): the
// device-side counterpart of _vpu_dft in fftw3_tpu/ops/pallas_stockham.py
// run as a Stockham stage, in place of the dense p-term sum of
// stockham_stage.cuh.
//
// A stage of radix p views the n points of a transform as (p, q, done) and
// computes, for every (j2, d), the p-point DFT over j1, the twiddle
// w = exp(sign*2*pi*i*k1*j2/rest) and the autosorted store to point
// (j2*p + k1)*done + d: exactly what stage() computes.  Here a 2-3-5-smooth
// radix is split into register levels r_1 * r_2 * ... = p, each at most 16
// (the host's choice, stockham.bfly_levels): level l is itself a Stockham
// stage of radix r_l at done_l = done * r_1 * ... * r_(l-1), and the chain of
// levels with their own twiddles equals the radix-p stage (the DIF
// factorisation of the p-point DFT; the level twiddles multiply out to the
// stage's).  One thread holds whole r-point butterflies in registers: it
// reads each point of a butterfly from shared memory once per level and
// writes it once, 4 words per point per level in place of the dense sum's
// 4p.  Inside a level the r-point DFT is the reference's _vpu_dft:
// recursive radix-4 with a radix-2 tail, radix-5 and radix-3, the level
// twiddles snapped to +-1/+-i where exact.
//
// Constants: every root is read from the host's f64 root tables cast to f32
// (the stage's r_rest, or its r_p when q == 1), w_m^e at index
// e * (len / m); the 3- and 5-point constants too.  The transform's sign is
// the sign of Im(table[1]).
//
// Layout: `nr` transforms of n points by tl columns in one shared-memory
// buffer, transform r at r*rs, point i of column c at element e = i*tl + c,
// stored at e + pad*(e >> 5).  The pad of the buffer a level writes is the
// host's choice (stockham.level_plan): with one butterfly per thread, a level's
// stores come in runs of done*tl words, r*done*tl apart, across a warp, and pad
// = min(done*tl, 32/r) spreads them over the 32 banks (no pad when done*tl >=
// 32); reads are contiguous.  A level runs in place: each thread loads all its
// butterflies, the block synchronises, then it computes and stores.  A stage
// whose radix has a prime factor of 7 or more runs stage() of
// stockham_stage.cuh instead (unpadded buffers, out of place).
//
// Plans: one form of the kernels runs every schedule.  The host's level plan
// (stockham.level_plan) arrives as a kernel argument, the kernel copies its
// levels to shared memory, and each level reads its geometry there at run
// time; the levels are inlined, one butterfly body per radix of
// LEVEL_RADICES.  Beside it, a plan compiled in (FixedLevel,
// run_fixed_levels): the same level bodies with every radix and geometry a
// constant, for a schedule a kernel instantiates (K3 at 512 x 512).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham_stage.cuh"

namespace fftw3_tpu_torch {

// E5's arms (ablate_stage.cu); every user path runs kFull.
struct Arm {
  static constexpr int kFull = 0, kNoTwiddle = 1, kConstRoots = 2,
                       kNoStage = 3;
};

// The layout bits of K1, K2 and K3 (their kLayout): the input, the output is
// one interleaved complex64 tensor, each point a float2 (re, im), in place
// of two float planes.
constexpr int kInC = 1, kOutC = 2;

// The levels take kPts, the points of a tile a thread holds at most in one
// level (tile points over threads per block; the host keeps every tile
// within it), as their first template argument.
constexpr int kMaxLevels = 8;

// Division by a divisor fixed per level, as a multiply and a shift: q =
// (umulhi(x, mul) + x) >> shift, exact for 0 <= x < 2^31 (Granlund and
// Montgomery).  fast_div sets it up on the host.
struct FastDiv {
  unsigned mul;
  int shift;
  __device__ __forceinline__ int div(int x) const {
    const unsigned u = static_cast<unsigned>(x);
    return static_cast<int>((__umulhi(u, mul) + u) >> shift);
  }
};

inline FastDiv fast_div(int d) {
  int s = 0;
  while ((1u << s) < static_cast<unsigned>(d)) ++s;
  const uint64_t m =
      ((uint64_t{1} << 32) * ((uint64_t{1} << s) - d)) / d + 1;
  return FastDiv{static_cast<unsigned>(m), s};
}

// One level of the plan: the 8 ints stockham.level_plan writes, then what
// read_plan derives from them for tiles of tl columns.
struct Level {
  int kind;  // 0: a dense stage() of radix r; else the butterfly radix r
  int r, done, rest;
  int off_a;  // butterfly: root table w_len^e (re, then im at +len);
              // dense: r_p (re, then im at +r)
  int off_b;  // dense: r_rest (re, then im at +rest) when rest > r
  int len;    // butterfly: length of the root table
  int pad;    // pad of the buffer this level writes (0 for the last)
  int q;      // rest / r
  int wstep;  // butterfly: len / rest, the table step of w_rest^1
  FastDiv per_row;  // q * done * tl, the butterflies of one transform
  FastDiv cols;     // tl
  FastDiv dn;       // done
};

// Header: number of levels, shared-memory buffers (1, or 2 with a dense
// stage), row stride rs of a buffer plane (floats), root-table floats.
struct LevelPlan {
  int nlev, nbuf, rs, tab_len;
  Level lev[kMaxLevels];
};

// Reads a plan for tiles of tl columns from the host's int array (4 + 8 *
// nlev ints); false when it does not fit.
inline bool read_plan(const int* p, int tl, LevelPlan* out) {
  if (p == nullptr || p[0] < 1 || p[0] > kMaxLevels || tl < 1) return false;
  *out = LevelPlan{};
  out->nlev = p[0];
  out->nbuf = p[1];
  out->rs = p[2];
  out->tab_len = p[3];
  for (int l = 0; l < out->nlev; ++l) {
    const int* v = p + 4 + 8 * l;
    Level& L = out->lev[l];
    L = Level{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
    const bool bfly = L.kind != 0;
    if (L.r < 2 || L.done < 1 || L.rest % L.r ||
        (bfly && (L.kind != L.r || L.len < L.rest || L.len % L.rest)) ||
        (bfly && L.r != 2 && L.r != 3 && L.r != 4 && L.r != 5 && L.r != 8 &&
         L.r != 16))
      return false;
    L.q = L.rest / L.r;
    L.wstep = bfly ? L.len / L.rest : 0;
    L.per_row = fast_div(L.q * L.done * tl);
    L.cols = fast_div(tl);
    L.dn = fast_div(L.done);
  }
  return true;
}

// Shared-memory bytes of a launch of K1 or K2 with nr transforms a group:
// the tables, then nbuf buffers of two planes of nr transforms at stride rs
// (stockham.plan_smem computes the same on the host).
inline int plan_smem(const LevelPlan& plan, int nr) {
  const int plane = (nr * plan.rs + 3) & ~3;
  return static_cast<int>(sizeof(float)) *
         (((plan.tab_len + 3) & ~3) + 2 * plan.nbuf * plane);
}

// Copies the plan's levels into shared memory, where a level is read at a
// run-time index (a kernel parameter read so is copied to local memory).
// The caller synchronises before they are read.
__device__ __forceinline__ void stage_levels(const LevelPlan& plan,
                                             Level* lev) {
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (static_cast<int>(threadIdx.x) == l) lev[l] = plan.lev[l];
}

// A root table in shared memory: w_len^e = (re[e], im[e]).
struct Roots {
  const float* re;
  const float* im;
  bool neg;  // sign < 0
};

__host__ __device__ constexpr int bfly_radix(int m) {
  return m % 4 == 0 ? 4 : m % 2 == 0 ? 2 : m % 5 == 0 ? 5 : 3;
}

// Register position of output k of the in-place m-point DFT below:
// X[k1 + r*k2] is child k1's output k2.
__host__ __device__ constexpr int bfly_pos(int m, int k) {
  return m == 1 ? 0
                : (k % bfly_radix(m)) * (m / bfly_radix(m)) +
                      bfly_pos(m / bfly_radix(m), k / bfly_radix(m));
}

// bfly_pos as a constant: the recursive function is not inlined, and a
// register array indexed through a call is demoted to local memory.
template <int M, int K>
struct BflyPos {
  static constexpr int value = bfly_pos(M, K);
};

// out[k] = in[bfly_pos(M, k)]: the DFT's outputs in natural order, every
// index a constant (a renaming of registers).
template <int M, int K = 0, int N>
__device__ __forceinline__ void natural_order(const float (&in)[N],
                                              float (&out)[M]) {
  if constexpr (K < M) {
    out[K] = in[BflyPos<M, K>::value];
    natural_order<M, K + 1>(in, out);
  }
}

template <int kArm>
__device__ __forceinline__ void root(const Roots& rt, int idx, float& wr,
                                     float& wi) {
  if (kArm == Arm::kConstRoots) {
    wr = 0.70710678f;
    wi = -0.70710678f;
  } else {
    wr = rt.re[idx];
    wi = rt.im[idx];
  }
}

// x *= w_m^e, e known at compile time after unrolling; exact at quarter
// turns (the reference's snapping to +-1/+-i).
template <int kArm>
__device__ __forceinline__ void twiddle(float& xr, float& xi, int m, int e,
                                        const Roots& rt, int unit) {
  if (e == 0) return;
  if ((4 * e) % m == 0) {
    const int quarter = 4 * e / m;  // w = (sign*i)^quarter
    if (quarter == 2) {
      xr = -xr;
      xi = -xi;
    } else {
      // sign*i (quarter 1) or -sign*i (quarter 3)
      const bool plus_i = (quarter == 1) != rt.neg;
      const float t = xr;
      xr = plus_i ? -xi : xi;
      xi = plus_i ? t : -t;
    }
    return;
  }
  float wr, wi;
  root<kArm>(rt, e * unit, wr, wi);
  const float t = xr * wr - xi * wi;
  xi = xr * wi + xi * wr;
  xr = t;
}

// The r-point butterfly on x[b + j*s], j < r, in place: output k at b + k*s.
// `unit` is the table step of w_m^1 for the DFT size m this butterfly
// starts (so w_r^1 sits at (m/r)*unit).
template <int R, int kArm, int N>
__device__ __forceinline__ void butterfly(float (&xr)[N], float (&xi)[N], int b,
                                          int s, int m, const Roots& rt,
                                          int unit) {
  if constexpr (R == 2) {
    const float ar = xr[b], ai = xi[b], cr = xr[b + s], ci = xi[b + s];
    xr[b] = ar + cr;
    xi[b] = ai + ci;
    xr[b + s] = ar - cr;
    xi[b + s] = ai - ci;
  } else if constexpr (R == 4) {
    const float x0r = xr[b], x0i = xi[b], x1r = xr[b + s], x1i = xi[b + s];
    const float x2r = xr[b + 2 * s], x2i = xi[b + 2 * s];
    const float x3r = xr[b + 3 * s], x3i = xi[b + 3 * s];
    const float t0r = x0r + x2r, t0i = x0i + x2i;
    const float t1r = x0r - x2r, t1i = x0i - x2i;
    const float t2r = x1r + x3r, t2i = x1i + x3i;
    const float t3r = x1r - x3r, t3i = x1i - x3i;
    // u3 = t3 * omega_4 = t3 * (sign*i)
    const float u3r = rt.neg ? t3i : -t3i;
    const float u3i = rt.neg ? -t3r : t3r;
    xr[b] = t0r + t2r;
    xi[b] = t0i + t2i;
    xr[b + s] = t1r + u3r;
    xi[b + s] = t1i + u3i;
    xr[b + 2 * s] = t0r - t2r;
    xi[b + 2 * s] = t0i - t2i;
    xr[b + 3 * s] = t1r - u3r;
    xi[b + 3 * s] = t1i - u3i;
  } else if constexpr (R == 3) {
    // X1/X2 = u +- i*v, u = x0 - t1/2, v = sign*S3*t3
    float c3, s3;
    root<kArm>(rt, (m / 3) * unit, c3, s3);
    const float x0r = xr[b], x0i = xi[b];
    const float t1r = xr[b + s] + xr[b + 2 * s];
    const float t1i = xi[b + s] + xi[b + 2 * s];
    const float t3r = xr[b + s] - xr[b + 2 * s];
    const float t3i = xi[b + s] - xi[b + 2 * s];
    const float ur = x0r - 0.5f * t1r, ui = x0i - 0.5f * t1i;
    const float vr = s3 * t3r, vi = s3 * t3i;
    xr[b] = x0r + t1r;
    xi[b] = x0i + t1i;
    xr[b + s] = ur - vi;
    xi[b + s] = ui + vr;
    xr[b + 2 * s] = ur + vi;
    xi[b + 2 * s] = ui - vr;
  } else {
    static_assert(R == 5, "butterflies of 2, 3, 4 and 5 points");
    float c1, s1, c2, s2;
    root<kArm>(rt, (m / 5) * unit, c1, s1);
    root<kArm>(rt, 2 * (m / 5) * unit, c2, s2);
    const float x0r = xr[b], x0i = xi[b];
    const float t1r = xr[b + s] + xr[b + 4 * s];
    const float t1i = xi[b + s] + xi[b + 4 * s];
    const float t2r = xr[b + 2 * s] + xr[b + 3 * s];
    const float t2i = xi[b + 2 * s] + xi[b + 3 * s];
    const float t3r = xr[b + s] - xr[b + 4 * s];
    const float t3i = xi[b + s] - xi[b + 4 * s];
    const float t4r = xr[b + 2 * s] - xr[b + 3 * s];
    const float t4i = xi[b + 2 * s] - xi[b + 3 * s];
    const float u1r = x0r + c1 * t1r + c2 * t2r;
    const float u1i = x0i + c1 * t1i + c2 * t2i;
    const float u2r = x0r + c2 * t1r + c1 * t2r;
    const float u2i = x0i + c2 * t1i + c1 * t2i;
    // s1, s2 carry the sign: v = sign * (the reference's v)
    const float v1r = s1 * t3r + s2 * t4r, v1i = s1 * t3i + s2 * t4i;
    const float v2r = s2 * t3r - s1 * t4r, v2i = s2 * t3i - s1 * t4i;
    xr[b] = x0r + t1r + t2r;
    xi[b] = x0i + t1i + t2i;
    xr[b + s] = u1r - v1i;
    xi[b + s] = u1i + v1r;
    xr[b + 2 * s] = u2r - v2i;
    xi[b + 2 * s] = u2i + v2r;
    xr[b + 3 * s] = u2r + v2i;
    xi[b + 3 * s] = u2i - v2r;
    xr[b + 4 * s] = u1r + v1i;
    xi[b + 4 * s] = u1i - v1r;
  }
}

// In-place M-point DFT of x[b .. b+M) in registers, output k at
// b + bfly_pos(M, k).  `unit` is the table step of w_M^1.
template <int M, int kArm, int N>
__device__ __forceinline__ void dft(float (&xr)[N], float (&xi)[N], int b,
                                    const Roots& rt, int unit) {
  if constexpr (M > 1) {
    constexpr int r = bfly_radix(M);
    constexpr int q = M / r;
#pragma unroll
    for (int jq = 0; jq < q; ++jq) {
      butterfly<r, kArm>(xr, xi, b + jq, q, M, rt, unit);
      if (q > 1) {
#pragma unroll
        for (int k1 = 1; k1 < r; ++k1)
          twiddle<kArm>(xr[b + k1 * q + jq], xi[b + k1 * q + jq], M,
                        (jq * k1) % M, rt, unit);
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < r; ++k1)
      dft<q, kArm>(xr, xi, b + k1 * q, rt, unit * r);
  }
}

// The last level's store of output point o of column c of transform `row`:
// to element map(row, o, c) of (dr, di) (store_point, stockham_stage.cuh)
// where the map stores column c.
template <class Map>
__device__ __forceinline__ void store_out(const Map& map, float* dr,
                                          float* di, int row, int o, int c,
                                          float vr, float vi) {
  if (map.stored(c)) store_point<Map>(dr, di, map(row, o, c), vr, vi);
}

// One butterfly level of radix R over nr transforms: reads (sr, si), rows
// rs_in apart, point i of column c at i * ld_in + c with pad_in (ld_in is
// tl in shared memory; a first level reading global memory passes the
// input's own stride), and writes (dr, di), rows rs apart with the level's
// pad (in place when they are the same buffer) or, when kLast, the output
// planes at map(row, o, c).  With kSrcC the level reads interleaved complex
// points instead, each one float2 (re, im) at that index of sr (si unused):
// a first level reading the caller's complex tensor.  Every index is
// computed from the level's ints, L a Level read at run time or a
// FixedLevel whose ints are constants; the register arrays are indexed by
// constants only.
template <int kPts, int R, int kArm, bool kLast, bool kSrcC = false,
          class Map, class Lv>
__device__ __forceinline__ void bfly_level(const float* sr, const float* si,
                                           int rs_in, int pad_in, int ld_in,
                                           float* dr, float* di, int rs,
                                           const Map& map, const float* tb,
                                           const Lv& L, int tl, int nr) {
  constexpr int K = (kPts + R - 1) / R;
  const int done = L.done, rest = L.rest, q = L.q;
  const int qd = q * done;
  const int per_row = qd * tl;  // butterflies per transform
  const int total = nr * per_row;
  const int len = L.len;
  const int unit = len / R;  // table step of w_R^1
  const int wstep = L.wstep;
  const int pad_out = L.pad;
  const float* rre = tb + L.off_a;
  const Roots rt{rre, rre + len, rre[len + 1] < 0.f};
  float xr[K][R], xi[K][R];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = threadIdx.x + k * blockDim.x;
    if (w < total) {
      const int row = L.per_row.div(w);
      const int t = w - row * per_row;
      const int jd = L.cols.div(t);
      const int c = t - jd * tl;
      if constexpr (kSrcC) {
        const float2* bc = reinterpret_cast<const float2*>(sr) + row * rs_in;
#pragma unroll
        for (int j1 = 0; j1 < R; ++j1) {
          const int e = (j1 * qd + jd) * ld_in + c;
          const float2 v = bc[e + pad_in * (e >> 5)];
          xr[k][j1] = v.x;
          xi[k][j1] = v.y;
        }
      } else {
        const float* br = sr + row * rs_in;
        const float* bi = si + row * rs_in;
#pragma unroll
        for (int j1 = 0; j1 < R; ++j1) {
          const int e = (j1 * qd + jd) * ld_in + c;
          const int a = e + pad_in * (e >> 5);
          xr[k][j1] = br[a];
          xi[k][j1] = bi[a];
        }
      }
    }
  }
  if (!kLast) __syncthreads();  // in place: every read is done
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = threadIdx.x + k * blockDim.x;
    if (w < total) {
      const int row = L.per_row.div(w);
      const int t = w - row * per_row;
      const int jd = L.cols.div(t);
      const int c = t - jd * tl;
      dft<R, kArm>(xr[k], xi[k], 0, rt, unit);
      float zr[R], zi[R];
      natural_order<R>(xr[k], zr);
      natural_order<R>(xi[k], zi);
      const int j2 = L.dn.div(jd);
      const int d = jd - j2 * done;
      if (kArm != Arm::kNoTwiddle && q > 1) {
        // w^k1, w = w_rest^j2: the powers of two from the table (index
        // 2^m * j2 mod rest by doubling), every other power the product of
        // two of them (about 1.5 ulp), so a butterfly reads log2(R) roots
        float wr[R], wi[R];
        int e = j2;  // (k1 * j2) mod rest for k1 = 1, 2, 4, ...
#pragma unroll
        for (int k1 = 1; k1 < R; ++k1) {
          if ((k1 & (k1 - 1)) == 0) {
            if (k1 > 1) {
              e += e;
              if (e >= rest) e -= rest;
            }
            root<Arm::kFull>(rt, e * wstep, wr[k1], wi[k1]);
          } else {
            const int hi = 1 << (31 - __clz(k1));
            const int lo = k1 - hi;
            wr[k1] = wr[hi] * wr[lo] - wi[hi] * wi[lo];
            wi[k1] = wr[hi] * wi[lo] + wi[hi] * wr[lo];
          }
          const float tr = zr[k1] * wr[k1] - zi[k1] * wi[k1];
          zi[k1] = zr[k1] * wi[k1] + zi[k1] * wr[k1];
          zr[k1] = tr;
        }
      }
#pragma unroll
      for (int k1 = 0; k1 < R; ++k1) {
        const int o = (j2 * R + k1) * done + d;
        if (kLast) {
          store_out(map, dr, di, row, o, c, zr[k1], zi[k1]);
        } else {
          const int e = o * tl + c;
          const int a = row * rs + e + pad_out * (e >> 5);
          dr[a] = zr[k1];
          di[a] = zi[k1];
        }
      }
    }
  }
}

// Stores nothing: the map type of the levels that write shared memory.
struct NoMap {
  __device__ __forceinline__ bool stored(int) const { return false; }
  __device__ __forceinline__ int operator()(int, int, int) const { return 0; }
};

// The butterfly level of radix L.kind.
template <int kPts, int kArm, bool kLast, bool kSrcC = false, class Map>
__device__ __forceinline__ void bfly_any(const float* sr, const float* si,
                                         int rs_in, int pad_in, int ld_in,
                                         float* dr, float* di, int rs,
                                         const Map& map, const float* tb,
                                         const Level& L, int tl, int nr) {
  switch (L.kind) {
    case 2:
      bfly_level<kPts, 2, kArm, kLast, kSrcC>(
          sr, si, rs_in, pad_in, ld_in, dr, di, rs, map, tb, L, tl, nr);
      break;
    case 3:
      bfly_level<kPts, 3, kArm, kLast, kSrcC>(
          sr, si, rs_in, pad_in, ld_in, dr, di, rs, map, tb, L, tl, nr);
      break;
    case 4:
      bfly_level<kPts, 4, kArm, kLast, kSrcC>(
          sr, si, rs_in, pad_in, ld_in, dr, di, rs, map, tb, L, tl, nr);
      break;
    case 5:
      bfly_level<kPts, 5, kArm, kLast, kSrcC>(
          sr, si, rs_in, pad_in, ld_in, dr, di, rs, map, tb, L, tl, nr);
      break;
    case 8:
      bfly_level<kPts, 8, kArm, kLast, kSrcC>(
          sr, si, rs_in, pad_in, ld_in, dr, di, rs, map, tb, L, tl, nr);
      break;
    default:
      bfly_level<kPts, 16, kArm, kLast, kSrcC>(
          sr, si, rs_in, pad_in, ld_in, dr, di, rs, map, tb, L, tl, nr);
      break;
  }
}

// A dense level: stage() of stockham_stage.cuh, out of place.
template <class Map>
__device__ __forceinline__ void dense_level(const Level& L, const float* tb,
                                            const float* sr, const float* si,
                                            float* dr, float* di,
                                            const Map& map, int n, int tl,
                                            int nr) {
  const float* rr = tb + L.off_a;
  const float* twr = L.q > 1 ? tb + L.off_b : nullptr;
  stage(sr, si, dr, di, map, rr, rr + L.r, twr,
        L.q > 1 ? twr + L.rest : nullptr, n, tl, nr, L.r, L.q, L.done,
        L.rest);
}

// The whole plan over the nr transforms in buffer (ar, ai); (br_, bi_) is
// the second buffer (used by dense stages only); `lev` is the plan's levels
// in shared memory.  With x0r (the caller has checked that level 0 is a
// butterfly level) level 0 reads the transforms from (x0r, x0i), rows x0_rs
// apart, point i of column c at i * x0_ld + c, in place of the buffer; with
// kSrcC from x0r alone, interleaved complex, those being float2 indices.
// The last level stores to (yr, yi)[map(row, o, c)].  The caller has
// synchronised after filling the buffer; nothing here synchronises after
// the last level.
template <int kPts, int kArm, bool kSrcC = false, class Map>
__device__ __forceinline__ void run_levels(
    const LevelPlan& plan, const Level* lev, const float* tb, float* ar,
    float* ai, float* br_, float* bi_, int n, int tl, int nr, float* yr,
    float* yi, const Map& map, const float* x0r = nullptr,
    const float* x0i = nullptr, int x0_rs = 0, int x0_ld = 1) {
  float* cr = ar;
  float* ci = ai;
  float* orr = br_;
  float* oi = bi_;
  const int nlev = plan.nlev, rs = plan.rs;
  int pad_in = 0;
  for (int l = 0; l < nlev; ++l) {
    const Level& L = lev[l];
    const bool last = l == nlev - 1;
    if (L.kind == 0) {
      if (last) {
        dense_level(L, tb, cr, ci, yr, yi, map, n, tl, nr);
      } else {
        dense_level(L, tb, cr, ci, orr, oi, SmemMap{n * tl, tl}, n, tl, nr);
        float* t = cr;
        cr = orr;
        orr = t;
        t = ci;
        ci = oi;
        oi = t;
      }
    } else {
      const bool direct = l == 0 && x0r != nullptr;
      if (kSrcC && direct) {
        if (last)
          bfly_any<kPts, kArm, true, true>(x0r, x0i, x0_rs, 0, x0_ld, yr, yi,
                                           rs, map, tb, L, tl, nr);
        else
          bfly_any<kPts, kArm, false, true>(x0r, x0i, x0_rs, 0, x0_ld, cr,
                                            ci, rs, NoMap{}, tb, L, tl, nr);
      } else {
        const float* sr = direct ? x0r : cr;
        const float* si = direct ? x0i : ci;
        const int rs_in = direct ? x0_rs : rs;
        const int ld_in = direct ? x0_ld : tl;
        if (last)
          bfly_any<kPts, kArm, true>(sr, si, rs_in, pad_in, ld_in, yr, yi, rs,
                                     map, tb, L, tl, nr);
        else
          bfly_any<kPts, kArm, false>(sr, si, rs_in, pad_in, ld_in, cr, ci,
                                      rs, NoMap{}, tb, L, tl, nr);
      }
    }
    pad_in = L.pad;
    if (!last) __syncthreads();
  }
}

// Division by a divisor fixed at compile time, exact for 0 <= x < 2^31
// (FastDiv's range): a shift for a power of two.
template <int D>
struct ConstDiv {
  __device__ __forceinline__ int div(int x) const {
    return static_cast<int>(static_cast<unsigned>(x) / D);
  }
};

// Level l of a plan compiled in: P::plan holds the host's ints
// (stockham.level_plan, 4 + 8 * nlev) for tiles of P::tl columns.  It reads
// as the Level that read_plan makes of them, every field a constant, and
// holds what run_levels keeps of the plan.  (Device code reads the plan
// only through these scalars: an element of a host array is not a value it
// may use.)
template <class P, int l>
struct FixedLevel {
  static constexpr int nlev = P::plan[0], nbuf = P::plan[1], rs = P::plan[2];
  static constexpr int kind = P::plan[4 + 8 * l], r = P::plan[5 + 8 * l],
                       done = P::plan[6 + 8 * l], rest = P::plan[7 + 8 * l],
                       off_a = P::plan[8 + 8 * l], len = P::plan[10 + 8 * l],
                       pad = P::plan[11 + 8 * l];
  static constexpr int q = rest / r, wstep = len / rest;
  // the pad of the buffer this level reads: the level before's
  static constexpr int pad_in = l == 0 ? 0 : P::plan[3 + 8 * l];
  static_assert(nbuf == 1 && l < nlev && kind == r && rest % r == 0 &&
                    len % rest == 0,
                "a butterfly level of a plan in one buffer");
  ConstDiv<q * done * P::tl> per_row;
  ConstDiv<P::tl> cols;
  ConstDiv<done> dn;
};

// run_levels on the plan P compiled in, from level l on: each level is the
// one bfly_level body of its radix with its geometry constant, so no plan
// is staged or read at run time and nothing switches on a radix.  P has
// butterfly levels only, in one buffer (ar, ai).  Level 0 reads (sr, si),
// rows rs_in apart, point i of column c at i * ld_in + c (the buffer
// itself at P's stride and P::tl, or run_levels' x0r and x0i; with kSrcC
// interleaved complex from sr alone), and the last stores to
// (yr, yi)[map(row, o, c)].  The same butterflies on the same table entries
// in the same order as run_levels on the same plan.  The caller has
// synchronised after filling the buffer; nothing here synchronises after
// the last level.
template <int kPts, class P, int kArm, bool kSrcC = false, int l = 0,
          class Map>
__device__ __forceinline__ void run_fixed_levels(
    const float* tb, const float* sr, const float* si, int rs_in, int ld_in,
    float* ar, float* ai, int nr, float* yr, float* yi, const Map& map) {
  using L = FixedLevel<P, l>;
  if constexpr (l == L::nlev - 1) {
    bfly_level<kPts, L::r, kArm, true, kSrcC>(sr, si, rs_in, L::pad_in,
                                              ld_in, yr, yi, L::rs, map, tb,
                                              L{}, P::tl, nr);
  } else {
    bfly_level<kPts, L::r, kArm, false, kSrcC>(sr, si, rs_in, L::pad_in,
                                               ld_in, ar, ai, L::rs, NoMap{},
                                               tb, L{}, P::tl, nr);
    __syncthreads();
    run_fixed_levels<kPts, P, kArm, false, l + 1>(tb, ar, ai, L::rs, P::tl,
                                                  ar, ai, nr, yr, yi, map);
  }
}

}  // namespace fftw3_tpu_torch
