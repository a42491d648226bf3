// The dense Stockham stage loop: the device-side counterpart of _stages in
// fftw3_tpu/ops/pallas_stockham.py in its matrix form, the p-term sum.  Who
// uses it: stage() is the dense level of the butterfly kernels K1-K6
// (stockham_bfly.cuh), which run it for a radix with a prime factor of 7 or
// more, and with the one- or two-stage schedule (Schedule) E5's dense arms
// (ablate_stage.cu).
//
// A stage runs over `rows` independent transforms held in shared memory.
// Transform r is an (n, tl) tile at src + r*n*tl: point i of column c sits at
// i*tl + c, so tl = 1 is a row (the last-axis form) and tl > 1 a tile of tl
// columns transformed along axis -2.  Stage s views the n points as
// (p, q, done) with index j1*q*done + j2*done + d, contracts j1 with the
// p-point DFT matrix F_p, multiplies by w = exp(sign*2*pi*i*k1*j2/rest) when
// q > 1, and stores output point (j2*p + k1)*done + d where the index map says:
// the autosorted order of the reference, with no bit reversal.
//
// F_p and the stage twiddle come from root tables r_p[e] = w_p^e and
// r_rest[e] = w_rest^e computed on the host in f64 and cast to f32, so
// F[j, k] = r_p[(j*k) % p] is bit-identical to the reference's constants.
// Table layout (floats), stage by stage: re(r_p), im(r_p), then re(r_rest),
// im(r_rest) when q > 1.  With two stages the second has q == 1.
//
// Work item w covers (transform r, point t, column c) with c fastest, so
// consecutive threads read consecutive shared-memory words in the p-term sum
// and the stores of one transform go to neighbouring addresses.  The
// functions are force-inlined: a caller that passes the literal 1 for rows
// or tl gets no division for it, and a caller's index map costs no call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fftw3_tpu_torch {

// Where a stage's output goes: a map (row, o, c) -> element index into the
// output planes, and whether column c is stored at all.  The planes
// themselves reach the stage as __restrict__ parameters, so the compiler may
// overlap the next output's loads with this output's stores.

// Shared memory, in the same (rows, n, tl) layout as the input.
struct SmemMap {
  int per;  // n * tl
  int tl;
  __device__ __forceinline__ bool stored(int) const { return true; }
  __device__ __forceinline__ int operator()(int row, int o, int c) const {
    return row * per + o * tl + c;
  }
};

// A map with `static constexpr bool kInterleaved = true` (K6's) stores a
// point as one float2 (re, im) at element map(row, o, c) of the first plane
// read as float2, in place of one float in each plane.  The choice is made
// at compile time: a map without the member gets the two planes' store.
template <class Map, class = void>
struct Interleaved : std::false_type {};
template <class Map>
struct Interleaved<Map, std::void_t<decltype(Map::kInterleaved)>>
    : std::bool_constant<Map::kInterleaved> {};

// The store of one output point (vr, vi) at element a of Map's layout.
template <class Map, class Index>
__device__ __forceinline__ void store_point(float* dr, float* di, Index a,
                                            float vr, float vi) {
  if constexpr (Interleaved<Map>::value) {
    reinterpret_cast<float2*>(dr)[a] = make_float2(vr, vi);
  } else {
    dr[a] = vr;
    di[a] = vi;
  }
}

// One Stockham stage: src (rows x n x tl, split) -> (dr, di)[map(row, o, c)].
template <class Map>
__device__ __forceinline__ void stage(const float* __restrict__ sr,
                                      const float* __restrict__ si,
                                      float* __restrict__ dr,
                                      float* __restrict__ di, const Map& map,
                                      const float* __restrict__ rootr,
                                      const float* __restrict__ rooti,
                                      const float* __restrict__ twr,
                                      const float* __restrict__ twi, int n,
                                      int tl, int rows, int p, int q,
                                      int done, int rest) {
  const int qd = q * done;
  const int per = n * tl;
  const int total = rows * per;
  const int jstride = qd * tl;
  for (int w = threadIdx.x; w < total; w += blockDim.x) {
    const int row = rows == 1 ? 0 : w / per;
    const int tt = w - row * per;
    const int t = tl == 1 ? tt : tt / tl;
    const int c = tt - t * tl;
    const int k1 = t / qd;
    const int jd = t - k1 * qd;  // j2 * done + d
    const float* xr = sr + row * per + jd * tl + c;
    const float* xi = si + row * per + jd * tl + c;
    float ar = 0.f, ai = 0.f;
    int e = 0;  // (j1 * k1) mod p, advanced by k1 each step
#pragma unroll 4
    for (int j1 = 0; j1 < p; ++j1) {
      const float vr = xr[j1 * jstride];
      const float vi = xi[j1 * jstride];
      const float fr = rootr[e];
      const float fi = rooti[e];
      ar = fmaf(fr, vr, ar);
      ar = fmaf(-fi, vi, ar);
      ai = fmaf(fi, vr, ai);
      ai = fmaf(fr, vi, ai);
      e += k1;
      if (e >= p) e -= p;
    }
    const int j2 = jd / done;
    const int d = jd - j2 * done;
    if (q > 1) {
      const int ew = (k1 * j2) % rest;
      const float wr = twr[ew];
      const float wi = twi[ew];
      const float tr = ar * wr - ai * wi;
      ai = ar * wi + ai * wr;
      ar = tr;
    }
    if (map.stored(c))
      store_point<Map>(dr, di, map(row, (j2 * p + k1) * done + d, c), ar, ai);
  }
}

// A one- or two-stage radix schedule and its root tables in shared memory
// (`tb`, in the table layout above), set up once per block.
struct Schedule {
  int n, nstages, p0, p1, q0;
  const float *r0r, *r0i, *t0r, *t0i, *r1r, *r1i;
  __device__ __forceinline__ Schedule(const float* tb, int n_, int nstages_,
                                      int p0_, int p1_)
      : n(n_), nstages(nstages_), p0(p0_), p1(p1_), q0(n_ / p0_) {
    r0r = tb;
    r0i = tb + p0;
    t0r = tb + 2 * p0;
    t0i = t0r + n;
    r1r = tb + 2 * p0 + (q0 > 1 ? 2 * n : 0);
    r1i = r1r + p1;
  }
};

}  // namespace fftw3_tpu_torch
