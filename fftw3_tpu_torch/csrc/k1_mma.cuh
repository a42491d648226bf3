// The body of E4, E6 and E9-E12: a whole n = 1024 forward c2c on split
// (rows, 1024) f32 planes, K1's two-stage Stockham schedule [P1, Q1]
// (P1 * Q1 = 1024) with each stage's complex product on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sum).  One template over the
// reference's arm axes; k1_mma_karatsuba.cu, k1_mma_stacked64.cu and
// k1_mma_stacked.cu instantiate the arms (see their headers for what each
// replaces) and ops/k1_mma.py names them.
//
// The schedule (pallas_stockham._stages, presplit_g._stages_presplit): a
// row is X[j1, j2] = x[j1 * Q1 + j2]; stage 1 is the P1-point DFT down its
// columns, Y1[k1, j2] = sum_j1 F[k1, j1] X[j1, j2], times the twiddle
// w[k1, j2] = exp(-2 pi i k1 j2 / 1024), stored autosorted as T[j2, k1];
// stage 2 is the Q1-point DFT down T's columns, Y2[k2, k1], which is
// y[k2 * P1 + k1].  Every product is bf16 hi/lo: hi = RNE bf16(v), lo =
// RNE bf16(v - hi) (__float2bfloat16_rn and an _rn subtraction, so every
// bf16 product is exact in f32 and only the summation order differs from
// the plain twin), hh + (hl + lh) with the lo * lo term dropped.
//
// The arm axes, each a template parameter where it changes the inner loop:
//  * form: kStacked, G [Xr; Xi] with G = [[Fr, -Fi], [Fi, Fr]] (only Fr
//    and Fi are kept as A fragments, -Fi is a sign-bit flip; at p = 8 the
//    stacked G is the one 16 x 16 A tile and B is [Xr; Xi] over K), or
//    kKaratsuba, t1 = Fr Xr, t2 = Fi Xi, t3 = (Fr + Fi)(Xr + Xi), Yr = t1 -
//    t2, Yi = (t3 - t1) - t2 (Xr + Xi formed in f32 before the split);
//  * grouping per stage: kThree (hh, hl, lh in accumulators of their own,
//    then hh + (hl + lh)), kFused (hl and lh in one accumulator, then
//    added to hh), kMono (all three in one), kNoxl (hh + lh in one, X
//    rounded to bf16 and never split);
//  * the inter-stage buffer: f32, or bf16 hi/lo halves (same bytes) laid
//    out [k1][j2] so that stage 2 loads its B fragments as 32-bit words
//    without a split;
//  * packing: a stage with 2p < 128 runs as the reference's block-diagonal
//    (2p r) x (2p r) product, r = 128 / (2p): the row's N columns in r
//    groups, every output tile summed over all r K groups, the off-
//    diagonal A tiles zero (r-fold MMAs; the zero tiles are registers, not
//    loads);
//  * diag: kCopy (load, shared buffer, store), kNoTw (no twiddle), kNoPerm
//    (stage 1's (P1, Q1) output read as (Q1, P1) without the autosort),
//    kNoPermNoTw; the reference's wrong numbers, on purpose.
// At run time: where G was split (host_split: the A fragments come from
// the host in mma order; else the block splits Fr and Fi from f32 into
// the same layout once, in its prologue), the repeat count (the two stages
// run reps times on the row group in shared memory, one HBM load and one
// store), and rows per block.
//
// Layout: 256 threads take groups of rpb whole rows (a grid-stride loop
// over groups; the last is ragged).  A group's planes are loaded with
// 16-byte loads into X at a row stride of Q1 + 4 floats; T (f32) has a row
// stride of P1 + 4, the bf16 buffer Q1/2 + 4 words: every B-fragment read
// and epilogue write of a warp falls on 32 distinct banks at Q1 = 8, 16,
// 32 and P1 = 32, 64, 128.  A warp task is one 8-column n-tile of one row
// and a group of complex output tiles (a complex tile is the Yr and Yi
// 16-row tiles of one k range; at p = 8 the one stacked tile), with the
// group sized to keep the accumulators within 64 registers; each B
// fragment is split once per task.  Stage 1's epilogue twiddles in
// registers (the (P1, Q1) table read through L1) and stores to T; stage
// 2's stores y[k2 P1 + k1] as 8-byte pairs, four lanes on one 32-byte
// sector.
//
// What bounds it on an H100: 16 bytes of HBM a point (two planes in, two
// out), 0.120 ms at B = 24576; the bf16 products are 24p flops a point a
// stage (16p noxl, 18p Karatsuba, r-fold packed), 0.029-0.117 ms at 989
// TFLOP/s, a rate mma.sync does not reach (wgmma is later work).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fftw3_tpu_torch {
namespace k1mma {

constexpr int kN = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;
// a cap on any arm's shared memory, set once per kernel
constexpr int kMaxSmem = 232448;

enum Form { kStacked = 0, kKaratsuba = 1 };
enum Group { kThree = 0, kFused = 1, kMono = 2, kNoxl = 3 };
enum Diag { kNone = 0, kCopy = 1, kNoTw = 2, kNoPerm = 3, kNoPermNoTw = 4 };

struct Args {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  // per stage: the A fragments in mma order (host_split) or Fr then Fi as
  // p x p f32
  const void* c1;
  const void* c2;
  // stage 1's twiddle, (P1, Q1) pairs (re, im)
  const float* tw;
  int rows, rpb, reps, host_split;
};

__host__ __device__ constexpr int nslots(int g) {
  return g == kThree ? 3 : g == kFused ? 2 : 1;
}
__host__ __device__ constexpr int slot_hl(int g) {
  return g == kThree || g == kFused ? 1 : 0;
}
__host__ __device__ constexpr int slot_lh(int g) {
  return g == kThree ? 2 : g == kFused ? 1 : 0;
}

// fragment sets: 0 = Frh Fih Frl Fil (stacked, p >= 16), 1 = Gh Gl (the
// stacked 16 x 16 G at p = 8), 2 = Frh Fih Fsh Frl Fil Fsl (Karatsuba,
// Fs = Fr + Fi)
__host__ __device__ constexpr int frag_kind(int form, int p) {
  return form == kKaratsuba ? 2 : p >= 16 ? 0 : 1;
}
__host__ __device__ constexpr int frag_mats(int kind) {
  return kind == 0 ? 4 : kind == 1 ? 2 : 6;
}
__host__ __device__ constexpr int frag_tiles(int kind, int p) {
  return kind == 1 ? 1 : p / 16;
}
// uint4 words of a stage's fragments
__host__ __device__ constexpr int frag_words(int kind, int p) {
  return frag_mats(kind) * frag_tiles(kind, p) * frag_tiles(kind, p) * 32;
}

// the largest power-of-two number of complex tiles a task takes, at most
// ct, with at most 64 accumulator floats
__host__ __device__ constexpr int pick_group(int ct, int per_tile) {
  int g = 1;
  while (g * 2 <= ct && g * 2 * per_tile <= 64) g *= 2;
  return g;
}

template <int kForm, int P1, bool kBf16>
struct Geo {
  static constexpr int Q1 = kN / P1;
  static constexpr int K1 = frag_kind(kForm, P1), K2 = frag_kind(kForm, Q1);
  static constexpr int F1 = frag_words(K1, P1), F2 = frag_words(K2, Q1);
  // X: (2, P1, Q1 + pad) floats; T: (2, Q1, P1 + pad) floats, or the bf16
  // halves (2 planes, hi/lo, P1, Q1/2 + pad) words
  static constexpr int XLD = Q1 + kPad, XPL = P1 * XLD;
  static constexpr int TLD = P1 + kPad, TPL = Q1 * TLD;
  static constexpr int WLD = Q1 / 2 + kPad, WPL = P1 * WLD;
  static constexpr int ROW = 2 * XPL + (kBf16 ? 4 * WPL : 2 * TPL);
  static int smem(int rpb) { return 16 * (F1 + F2) + 4 * rpb * ROW; }
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ __nv_bfloat16 lo_of(float v, __nv_bfloat16 h) {
  return __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(h)));
}

// (a, b) -> bf16 hi halves and bf16 lo halves of the residuals, RNE
__device__ __forceinline__ void split2(float a, float b, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a);
  const __nv_bfloat16 bh = __float2bfloat16_rn(b);
  *hi = pack_bf16(ah, bh);
  if (lo != nullptr) *lo = pack_bf16(lo_of(a, ah), lo_of(b, bh));
}

__device__ __forceinline__ uint4 neg_bf16x8(uint4 a) {
  const uint32_t s = 0x80008000u;
  return make_uint4(a.x ^ s, a.y ^ s, a.z ^ s, a.w ^ s);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sum
__device__ __forceinline__ void mma(float (&d)[4], uint4 a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// element (row, col) of fragment matrix t of set `kind` from Fr, Fi (p x p
// f32 at f, f + p * p): hi or lo half of Fr, Fi, Fr + Fi, or the stacked G
// at p = 8
template <int kind, int P>
__device__ __forceinline__ __nv_bfloat16 frag_elem(const float* f, int t,
                                                   int row, int col) {
  const float* fr = f;
  const float* fi = f + P * P;
  float v;
  bool lo;
  if (kind == 1) {
    const int r = row & 7, c = col & 7;
    const bool ri = row >= 8, ci = col >= 8;
    v = ri == ci ? __ldg(fr + r * P + c) : __ldg(fi + r * P + c);
    if (!ri && ci) v = -v;
    lo = t == 1;
  } else {
    const int m = kind == 0 ? t & 1 : t % 3;  // 0 Fr, 1 Fi, 2 Fr + Fi
    lo = kind == 0 ? t >= 2 : t >= 3;
    const float a = __ldg(fr + row * P + col), b = __ldg(fi + row * P + col);
    v = m == 0 ? a : m == 1 ? b : __fadd_rn(a, b);
  }
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  return lo ? lo_of(v, h) : h;
}

// A stage's fragments into shared memory: copied from the host's words, or
// split here from Fr and Fi.  Word ((m * T + k) * NM + t) * 32 + lane holds
// rows 16m + gid (+8) and columns 16k + 2 tig (+1, +8, +9) of matrix t
// (stage4096.mma_fragments' layout).
template <int kind, int P>
__device__ void build_frags(uint4* dst, const void* src, bool host_split) {
  constexpr int NM = frag_mats(kind), T = frag_tiles(kind, P);
  constexpr int W = frag_words(kind, P);
  if (host_split) {
    for (int w = threadIdx.x; w < W; w += kThreads)
      dst[w] = __ldg(reinterpret_cast<const uint4*>(src) + w);
    return;
  }
  const float* f = reinterpret_cast<const float*>(src);
  for (int w = threadIdx.x; w < W; w += kThreads) {
    const int lane = w & 31, gid = lane >> 2, tig = lane & 3;
    const int t = (w >> 5) % NM, mk = (w >> 5) / NM;
    const int m = mk / T, k = mk - m * T;
    uint32_t r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * m + gid + 8 * (q & 1);
      const int col = 16 * k + 2 * tig + 8 * (q >> 1);
      r[q] = pack_bf16(frag_elem<kind, P>(f, t, row, col),
                       frag_elem<kind, P>(f, t, row, col + 1));
    }
    dst[w] = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// f32 planes of a row group: element (row b, plane c, j, col)
struct F32Buf {
  float* p;
  int row, plane, ld;
  __device__ __forceinline__ float get(int b, int c, int j, int col) const {
    return p[b * row + c * plane + j * ld + col];
  }
  // the B-fragment pair (j, col), (j + 1, col), split
  __device__ __forceinline__ void pair(int b, int c, int j, int col,
                                       uint32_t* hi, uint32_t* lo) const {
    split2(get(b, c, j, col), get(b, c, j + 1, col), hi, lo);
  }
};

// the bf16 inter-stage buffer: word (row b, plane c, half h, col, j / 2)
// holds the halves of (j, col) and (j + 1, col)
struct Bf16Buf {
  uint32_t* p;
  int row, half, ld;
  __device__ __forceinline__ uint32_t* at(int b, int c, int h, int col,
                                          int j) const {
    return p + b * row + (2 * c + h) * half + col * ld + (j >> 1);
  }
  __device__ __forceinline__ void pair(int b, int c, int j, int col,
                                       uint32_t* hi, uint32_t* lo) const {
    *hi = *at(b, c, 0, col, j);
    if (lo != nullptr) *lo = *at(b, c, 1, col, j);
  }
};

// One stacked stage, G [Xr; Xi] (radix P over N columns a row), on the nr
// rows of a group; epi(b, k, col, yr, yi, yr', yi') takes the outputs at
// (k, col) and (k, col + 1).
template <int P, int N, int G, bool kPack, class Buf, class Epi>
__device__ __forceinline__ void stacked_stage(const uint4* frag, const Buf& x,
                                              int nr, const Epi& epi) {
  constexpr int SUB = P >= 16 ? P / 16 : 1;
  constexpr int RP = kPack && 2 * P < 128 ? 128 / (2 * P) : 1;
  constexpr int NG = N / RP, NTP = NG / 8, CT = RP * SUB;
  constexpr int NS = nslots(G), SHL = slot_hl(G), SLH = slot_lh(G);
  constexpr int CG = pick_group(CT, (P >= 16 ? 8 : 4) * NS);
  constexpr int TASKS = NTP * (CT / CG);
  constexpr bool kLo = G != kNoxl;
  static_assert(NG % 8 == 0 && CT % CG == 0, "stage tiling");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int task = warp; task < nr * TASKS; task += kWarps) {
    const int b = task / TASKS;
    const int t = task - b * TASKS;
    const int nt = t % NTP, cg = t / NTP;
    float acc[CG][NS][2][4];
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[c][s][e >> 2][e & 3] = 0.f;
#pragma unroll
    for (int ig = 0; ig < RP; ++ig) {
      const int col = ig * NG + nt * 8 + gid;
#pragma unroll
      for (int kt = 0; kt < SUB; ++kt) {
        if constexpr (P >= 16) {
          uint32_t rh[2], rl[2], ih[2], il[2];
          const int j = kt * 16 + 2 * tig;
          x.pair(b, 0, j, col, &rh[0], kLo ? &rl[0] : nullptr);
          x.pair(b, 0, j + 8, col, &rh[1], kLo ? &rl[1] : nullptr);
          x.pair(b, 1, j, col, &ih[0], kLo ? &il[0] : nullptr);
          x.pair(b, 1, j + 8, col, &ih[1], kLo ? &il[1] : nullptr);
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            const int ct = cg * CG + c;
            const int a = ct % SUB;
            const bool on = RP == 1 || ct / SUB == ig;
            const uint4* f = frag + (a * SUB + kt) * 128 + lane;
            const uint4 frh = on ? f[0] : zero, fih = on ? f[32] : zero;
            const uint4 frl = on ? f[64] : zero, fil = on ? f[96] : zero;
            const uint4 nfih = neg_bf16x8(fih), nfil = neg_bf16x8(fil);
            mma(acc[c][0][0], frh, rh[0], rh[1]);
            mma(acc[c][0][0], nfih, ih[0], ih[1]);
            mma(acc[c][0][1], fih, rh[0], rh[1]);
            mma(acc[c][0][1], frh, ih[0], ih[1]);
            if constexpr (kLo) {
              mma(acc[c][SHL][0], frh, rl[0], rl[1]);
              mma(acc[c][SHL][0], nfih, il[0], il[1]);
              mma(acc[c][SHL][1], fih, rl[0], rl[1]);
              mma(acc[c][SHL][1], frh, il[0], il[1]);
            }
            mma(acc[c][SLH][0], frl, rh[0], rh[1]);
            mma(acc[c][SLH][0], nfil, ih[0], ih[1]);
            mma(acc[c][SLH][1], fil, rh[0], rh[1]);
            mma(acc[c][SLH][1], frl, ih[0], ih[1]);
          }
        } else {
          // K rows 0-7 are Xr, 8-15 Xi; M rows 0-7 Yr, 8-15 Yi
          uint32_t h[2], l[2];
          x.pair(b, 0, 2 * tig, col, &h[0], kLo ? &l[0] : nullptr);
          x.pair(b, 1, 2 * tig, col, &h[1], kLo ? &l[1] : nullptr);
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            const int ct = cg * CG + c;
            const bool on = RP == 1 || ct == ig;
            const uint4 gh = on ? frag[lane] : zero;
            const uint4 gl = on ? frag[32 + lane] : zero;
            mma(acc[c][0][0], gh, h[0], h[1]);
            if constexpr (kLo) mma(acc[c][SHL][0], gh, l[0], l[1]);
            mma(acc[c][SLH][0], gl, h[0], h[1]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      float y[2][4];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int h = e >> 2, q = e & 3;
        float v = acc[c][0][h][q];
        if constexpr (G == kThree)
          v = v + (acc[c][1][h][q] + acc[c][2][h][q]);
        else if constexpr (G == kFused)
          v = v + acc[c][1][h][q];
        y[h][q] = v;
      }
      const int ct = cg * CG + c;
      const int col = (ct / SUB) * NG + nt * 8 + 2 * tig;
      if constexpr (P >= 16) {
        const int k = (ct % SUB) * 16 + gid;
        epi(b, k, col, y[0][0], y[1][0], y[0][1], y[1][1]);
        epi(b, k + 8, col, y[0][2], y[1][2], y[0][3], y[1][3]);
      } else {
        epi(b, gid, col, y[0][0], y[0][2], y[0][1], y[0][3]);
      }
    }
  }
}

// One Karatsuba stage (radix P >= 16 over N columns a row, f32 buffer).
template <int P, int N, int G, class Epi>
__device__ __forceinline__ void karatsuba_stage(const uint4* frag,
                                                const F32Buf& x, int nr,
                                                const Epi& epi) {
  constexpr int SUB = P / 16, NT = N / 8;
  constexpr int NS = nslots(G), SHL = slot_hl(G), SLH = slot_lh(G);
  constexpr int CG = pick_group(SUB, 12 * NS);
  constexpr int TASKS = NT * (SUB / CG);
  static_assert(G == kThree || G == kFused, "Karatsuba groupings");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int task = warp; task < nr * TASKS; task += kWarps) {
    const int b = task / TASKS;
    const int t = task - b * TASKS;
    const int nt = t % NT, cg = t / NT;
    const int col = nt * 8 + gid;
    float acc[CG][3][NS][4];
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][m][s][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < SUB; ++kt) {
      // B: (Xr, Xi, Xr + Xi) at rows j, j + 1, j + 8, j + 9, split
      uint32_t hi[3][2], lo[3][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = kt * 16 + 2 * tig + 8 * hh;
        const float r0 = x.get(b, 0, j, col), r1 = x.get(b, 0, j + 1, col);
        const float i0 = x.get(b, 1, j, col), i1 = x.get(b, 1, j + 1, col);
        split2(r0, r1, &hi[0][hh], &lo[0][hh]);
        split2(i0, i1, &hi[1][hh], &lo[1][hh]);
        split2(__fadd_rn(r0, i0), __fadd_rn(r1, i1), &hi[2][hh], &lo[2][hh]);
      }
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const int a = cg * CG + c;
        const uint4* f = frag + (a * SUB + kt) * 192 + lane;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const uint4 fh = f[32 * m], fl = f[32 * (m + 3)];
          mma(acc[c][m][0], fh, hi[m][0], hi[m][1]);
          mma(acc[c][m][SHL], fh, lo[m][0], lo[m][1]);
          mma(acc[c][m][SLH], fl, hi[m][0], hi[m][1]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      float yr[4], yi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float tm[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          float v = acc[c][m][0][e];
          if constexpr (G == kThree)
            v = v + (acc[c][m][1][e] + acc[c][m][2][e]);
          else
            v = v + acc[c][m][1][e];
          tm[m] = v;
        }
        yr[e] = tm[0] - tm[1];
        yi[e] = (tm[2] - tm[0]) - tm[1];
      }
      const int k = (cg * CG + c) * 16 + gid;
      const int cc = nt * 8 + 2 * tig;
      epi(b, k, cc, yr[0], yi[0], yr[1], yi[1]);
      epi(b, k + 8, cc, yr[2], yi[2], yr[3], yi[3]);
    }
  }
}

// Stage 1's epilogue: the twiddle, then T[j2][k1] (or, without the
// autosort, point k1 * Q1 + j2 of T read as (Q1, P1)); bf16 halves into
// the bf16 buffer.
template <int P1, bool kBf16, int kDiag>
struct Stage1Out {
  static constexpr int Q1 = kN / P1;
  const float* tw;
  F32Buf t;
  Bf16Buf w;
  __device__ __forceinline__ void operator()(int b, int k1, int j2, float r0,
                                             float i0, float r1,
                                             float i1) const {
    if (kDiag != kNoTw && kDiag != kNoPermNoTw) {
      const float4 c = __ldg(
          reinterpret_cast<const float4*>(tw + 2 * (k1 * Q1 + j2)));
      float u = r0 * c.x - i0 * c.y;
      i0 = r0 * c.y + i0 * c.x;
      r0 = u;
      u = r1 * c.z - i1 * c.w;
      i1 = r1 * c.w + i1 * c.z;
      r1 = u;
    }
    if constexpr (kBf16) {
      split2(r0, r1, w.at(b, 0, 0, k1, j2), w.at(b, 0, 1, k1, j2));
      split2(i0, i1, w.at(b, 1, 0, k1, j2), w.at(b, 1, 1, k1, j2));
    } else if constexpr (kDiag == kNoPerm || kDiag == kNoPermNoTw) {
      const int f = k1 * Q1 + j2, row = f / P1, col = f - row * P1;
      float* pr = t.p + b * t.row + row * t.ld + col;
      pr[0] = r0;
      pr[1] = r1;
      pr[t.plane] = i0;
      pr[t.plane + 1] = i1;
    } else {
      float* pr = t.p + b * t.row + j2 * t.ld + k1;
      pr[0] = r0;
      pr[t.ld] = r1;
      pr[t.plane] = i0;
      pr[t.plane + t.ld] = i1;
    }
  }
};

// Stage 2's epilogue: y[k2 * P1 + k1] and the next point, to global memory
// (the last pass) or back into X (another pass of the repeat)
template <int P1>
struct Stage2Out {
  static constexpr int Q1 = kN / P1;
  float* yr;
  float* yi;
  int64_t r0;
  F32Buf x;
  bool global;
  __device__ __forceinline__ void operator()(int b, int k2, int k1, float a0,
                                             float b0, float a1,
                                             float b1) const {
    const int f = k2 * P1 + k1;
    float* pr;
    float* pi;
    if (global) {
      pr = yr + (r0 + b) * kN + f;
      pi = yi + (r0 + b) * kN + f;
    } else {
      const int row = f / Q1;
      pr = x.p + b * x.row + row * x.ld + (f - row * Q1);
      pi = pr + x.plane;
    }
    *reinterpret_cast<float2*>(pr) = make_float2(a0, a1);
    *reinterpret_cast<float2*>(pi) = make_float2(b0, b1);
  }
};

// the rows of a group between global memory and X, 16-byte accesses;
// kLoad picks the direction
template <bool kLoad, int Q1, int XLD, int XPL, int ROW>
__device__ __forceinline__ void move_rows(const Args& a, float* X, int64_t r0,
                                          int nr) {
  constexpr int N4 = kN / 4;
  for (int i = threadIdx.x; i < nr * 2 * N4; i += kThreads) {
    const int b = i / (2 * N4);
    const int rest = i - b * 2 * N4;
    const int c = rest / N4;
    const int e = 4 * (rest - c * N4);
    const int j1 = e / Q1;
    float4* s = reinterpret_cast<float4*>(X + b * ROW + c * XPL + j1 * XLD +
                                          (e - j1 * Q1));
    const int64_t g = (r0 + b) * kN + e;
    if (kLoad)
      *s = __ldg(reinterpret_cast<const float4*>((c ? a.xi : a.xr) + g));
    else
      *reinterpret_cast<float4*>((c ? a.yi : a.yr) + g) = *s;
  }
}

template <int kForm, int P1, int kG1, int kG2, bool kBf16, bool kPack,
          int kDiag>
__global__ void __launch_bounds__(kThreads, 1) k1_mma_kernel(const Args a) {
  using Ge = Geo<kForm, P1, kBf16>;
  constexpr int Q1 = Ge::Q1;
  static_assert(kForm == kStacked || (!kBf16 && !kPack && P1 == 32),
                "Karatsuba runs [32, 32] on f32 buffers");
  extern __shared__ uint4 smem4[];
  uint4* f1 = smem4;
  uint4* f2 = f1 + Ge::F1;
  float* rows = reinterpret_cast<float*>(f2 + Ge::F2);
  if (kDiag != kCopy) {
    build_frags<Ge::K1, P1>(f1, a.c1, a.host_split);
    build_frags<Ge::K2, Q1>(f2, a.c2, a.host_split);
  }
  const F32Buf X{rows, Ge::ROW, Ge::XPL, Ge::XLD};
  const F32Buf T{rows + 2 * Ge::XPL, Ge::ROW, Ge::TPL, Ge::TLD};
  const Bf16Buf W{reinterpret_cast<uint32_t*>(rows + 2 * Ge::XPL), Ge::ROW,
                  Ge::WPL, Ge::WLD};
  const Stage1Out<P1, kBf16, kDiag> out1{a.tw, T, W};
  const int groups = (a.rows + a.rpb - 1) / a.rpb;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * a.rpb;
    const int nr = a.rows - r0 < a.rpb ? static_cast<int>(a.rows - r0)
                                       : a.rpb;
    __syncthreads();  // the fragments are in; the previous group is done
    move_rows<true, Q1, Ge::XLD, Ge::XPL, Ge::ROW>(a, rows, r0, nr);
    __syncthreads();
    if constexpr (kDiag == kCopy) {
      move_rows<false, Q1, Ge::XLD, Ge::XPL, Ge::ROW>(a, rows, r0, nr);
      continue;
    }
    for (int rep = 0; rep < a.reps; ++rep) {
      if constexpr (kForm == kKaratsuba)
        karatsuba_stage<P1, Q1, kG1>(f1, X, nr, out1);
      else
        stacked_stage<P1, Q1, kG1, kPack>(f1, X, nr, out1);
      __syncthreads();
      const Stage2Out<P1> out2{a.yr, a.yi, r0, X, rep == a.reps - 1};
      if constexpr (kForm == kKaratsuba)
        karatsuba_stage<Q1, P1, kG2>(f2, T, nr, out2);
      else if constexpr (kBf16)
        stacked_stage<Q1, P1, kG2, kPack>(f2, W, nr, out2);
      else
        stacked_stage<Q1, P1, kG2, kPack>(f2, T, nr, out2);
      if (rep != a.reps - 1) __syncthreads();
    }
  }
}

// Allow the arm kMaxSmem bytes of dynamic shared memory and report how
// many blocks of `smem` bytes fit on one SM (launch = false), or launch
// `grid` blocks on `stream`.  Returns the CUDA error code, 0 on success.
template <int kForm, int P1, int kG1, int kG2, bool kBf16, bool kPack,
          int kDiag>
int run(bool launch, const Args& a, int grid, int smem, cudaStream_t stream,
        int* blocks_per_sm) {
  using Ge = Geo<kForm, P1, kBf16>;
  auto fn = k1_mma_kernel<kForm, P1, kG1, kG2, kBf16, kPack, kDiag>;
  if (!launch) {
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fn, kThreads, static_cast<size_t>(smem)));
  }
  if (a.rows < 1 || a.rpb < 1 || a.reps < 1 || smem != Ge::smem(a.rpb) ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  fn<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k1mma
}  // namespace fftw3_tpu_torch

// The C entry points of one instantiating source: NAME_occupancy(variant,
// smem, blocks_per_sm) and NAME_launch(variant, xr, xi, yr, yi, c1, c2, tw,
// rows, rpb, reps, host_split, grid, smem, stream), both on the caller's
// current device, both returning the CUDA error code.  DISPATCH is a
// function (variant, launch, args, grid, smem, stream, blocks_per_sm).
#define K1_MMA_ENTRY_POINTS(NAME, DISPATCH)                                  \
  extern "C" int NAME##_occupancy(int variant, int smem,                     \
                                  int* blocks_per_sm) {                      \
    fftw3_tpu_torch::k1mma::Args a{};                                        \
    return DISPATCH(variant, false, a, 0, smem, nullptr, blocks_per_sm);     \
  }                                                                          \
  extern "C" int NAME##_launch(int variant, const float* xr, const float* xi, \
                               float* yr, float* yi, const void* c1,         \
                               const void* c2, const float* tw, int rows,    \
                               int rpb, int reps, int host_split, int grid,  \
                               int smem, void* stream) {                     \
    const fftw3_tpu_torch::k1mma::Args a{xr, xi, yr, yi, c1, c2, tw, rows,   \
                                         rpb, reps, host_split};             \
    return DISPATCH(variant, true, a, grid, smem,                            \
                    static_cast<cudaStream_t>(stream), nullptr);             \
  }
