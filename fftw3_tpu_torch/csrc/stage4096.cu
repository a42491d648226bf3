// E2 and E3, the wide first stage built op by op: timing-only kernels on
// split (rows, n) f32 planes at n = p * q, (p, q) = (64, 64) at n = 4096 and
// (128, 16) at n = 2048.  Hand-written for Hopper (sm_90a).  Nothing on a
// user's path reaches these entry points.
//
// Replaces the TPU measurement scripts experiments/bisect4096.py (run_case,
// pallas_call at :29; the bodies k_identity, k_transpose, k_stage1,
// k_stage1_tw_perm) and experiments/bisect4096b.py (run_case, pallas_call at
// :28; k_stage1 in three precisions).  A row is the (p, q) matrix X[j1, j2]
// = x[j1 * q + j2] of each plane; the first stage of the four-step is the
// p-point DFT F[k1, j1] = exp(-2 pi i k1 j1 / p) down its columns.  Arms:
//  0 identity: y = x through shared memory;
//  1 roundtrip: y = x through two transposes in shared memory, (p, q) ->
//    (q, p) -> (p, q), each read column by column (the counterpart of the
//    reference's double transpose);
//  2 stage1_f32: Y = F X with an f32 sum on the FP32 units, y[k1 q + j2];
//  3 stage1_tw_perm: Y times w[k1, j2] = exp(-2 pi i k1 j2 / n), stored
//    autosorted at j2 p + k1;
//  4 stage1_ps: Y = Fh Xh + Fh Xl + Fl Xh on the tensor cores (mma.sync
//    m16n8k16, bf16 operands, f32 sum), X split into bf16 hi and lo with
//    round-to-nearest-even (__float2bfloat16_rn) and Xl = bf16(x - Xh),
//    every product exact in f32 (the reference's presplit 3-pass form);
//  5 stage1_bf16: Y = Fh bf16(X), one pass (about 2e-3 off: a measurement
//    arm, not a solver).
// The complex product runs on F's real and imaginary parts, never on the
// reference's stacked 2p x 2p G = [[Fr, -Fi], [Fi, Fr]]: the F32 arms keep
// Fr and Fi in shared memory as p x p floats (F is symmetric), the
// tensor-core arms keep Frh, Fih (and Frl, Fil) as bf16 A fragments laid out
// on the host in mma order, one 16-byte load a lane per fragment, and take
// -Fi by flipping the sign bits of Fi's fragments.
//
// Layout: 256 threads take groups of rpb whole rows (the host sweeps rpb;
// the TPU's row tile has no counterpart here).  A group's planes are loaded
// with 16-byte loads into shared memory at a row stride of q + 4 floats,
// which keeps a warp's column reads (the mma B fragments: eight columns by
// rows 2 apart) on 32 distinct banks.  The F32 arms give each thread a 4 x 4
// tile of (k1, j2) outputs (two 16-byte shared loads of X and two of F per
// j1, 64 FMAs), the tensor-core arms give each warp one 8-column tile of a
// row and all p/16 row tiles of k1, so a B fragment is split once and used
// by every A fragment.  Stores are 16 bytes (F32 arms) or 8 bytes (mma
// accumulators), consecutive across lanes.
//
// What bounds them on an H100: 16 bytes of HBM traffic per point (two
// planes in, two out), 0.080 ms at (4096, 4096); the dense stage is 8p flops
// a point, 8.6 GFLOP at p = 64 (0.13 ms at 67 TFLOP/s of FP32), 17.2 at
// p = 128, and the ps arm's three bf16 passes run at 989 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fftw3_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPadX = 4;
// a cap on any arm's shared memory, set once per kernel
constexpr int kMaxSmem = 232448;

enum Arm {
  kIdentity = 0,
  kRoundtrip = 1,
  kF32 = 2,
  kTwPerm = 3,
  kPs = 4,
  kBf16 = 5,
};

// floats of the constants region: Fr, Fi (F32 arms) or the A fragments
// (8 p^2 bytes for ps, 4 p^2 for bf16)
template <int kArm, int P>
__host__ __device__ constexpr int const_floats() {
  return kArm == kF32 || kArm == kTwPerm ? 2 * P * P
         : kArm == kPs                   ? 2 * P * P
         : kArm == kBf16                 ? P * P
                                         : 0;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (a, b) -> bf16 hi halves and bf16 lo halves of the residuals, RNE
__device__ __forceinline__ void split2(float a, float b, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a);
  const __nv_bfloat16 bh = __float2bfloat16_rn(b);
  *hi = pack_bf16(ah, bh);
  if (lo != nullptr)
    *lo = pack_bf16(__float2bfloat16_rn(__fsub_rn(a, __bfloat162float(ah))),
                    __float2bfloat16_rn(__fsub_rn(b, __bfloat162float(bh))));
}

__device__ __forceinline__ uint4 neg_bf16x8(uint4 a) {
  const uint32_t s = 0x80008000u;
  return make_uint4(a.x ^ s, a.y ^ s, a.z ^ s, a.w ^ s);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint4 a,
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

// the rows of a group between global memory and shared memory (row stride
// q + kPadX), 16-byte accesses; kLoad picks the direction
template <bool kLoad, int P, int Q>
__device__ __forceinline__ void move_rows(const float* __restrict__ xr,
                                          const float* __restrict__ xi,
                                          float* __restrict__ yr,
                                          float* __restrict__ yi, float* X,
                                          int64_t r0, int nr) {
  constexpr int N = P * Q, N4 = N / 4, XS = P * (Q + kPadX);
  for (int i = threadIdx.x; i < nr * 2 * N4; i += kThreads) {
    const int b = i / (2 * N4);
    const int rest = i - b * 2 * N4;
    const int c = rest / N4;
    const int e = 4 * (rest - c * N4);
    const int j1 = e / Q;
    float4* s = reinterpret_cast<float4*>(X + (2 * b + c) * XS +
                                          j1 * (Q + kPadX) + (e - j1 * Q));
    const int64_t g = (r0 + b) * N + e;
    if (kLoad)
      *s = __ldg(reinterpret_cast<const float4*>((c ? xi : xr) + g));
    else
      *reinterpret_cast<float4*>((c ? yi : yr) + g) = *s;
  }
}

template <int kArm, int P, int Q>
__device__ __forceinline__ void stage_f32(const float* X, const float* F,
                                          float* __restrict__ yr,
                                          float* __restrict__ yi,
                                          const float* __restrict__ twr,
                                          const float* __restrict__ twi,
                                          int64_t r0, int nr) {
  constexpr int N = P * Q, XS = P * (Q + kPadX), KG = P / 4, JG = Q / 4;
  for (int t = threadIdx.x; t < nr * KG * JG; t += kThreads) {
    const int b = t / (KG * JG);
    const int u = t - b * KG * JG;
    // the fastest index of a warp follows the store's contiguous axis
    const int jg = kArm == kF32 ? u % JG : u / KG;
    const int kg = kArm == kF32 ? u / JG : u % KG;
    const float* Xr = X + 2 * b * XS + 4 * jg;
    const float* Xi = Xr + XS;
    float ar[4][4], ai[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) ar[i][c] = ai[i][c] = 0.f;
#pragma unroll 4
    for (int j1 = 0; j1 < P; ++j1) {
      const float4 xr4 =
          *reinterpret_cast<const float4*>(Xr + j1 * (Q + kPadX));
      const float4 xi4 =
          *reinterpret_cast<const float4*>(Xi + j1 * (Q + kPadX));
      const float4 fr4 = *reinterpret_cast<const float4*>(F + j1 * P + 4 * kg);
      const float4 fi4 =
          *reinterpret_cast<const float4*>(F + P * P + j1 * P + 4 * kg);
      const float xrv[4] = {xr4.x, xr4.y, xr4.z, xr4.w};
      const float xiv[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
      const float frv[4] = {fr4.x, fr4.y, fr4.z, fr4.w};
      const float fiv[4] = {fi4.x, fi4.y, fi4.z, fi4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ar[i][c] = fmaf(frv[i], xrv[c], fmaf(-fiv[i], xiv[c], ar[i][c]));
          ai[i][c] = fmaf(frv[i], xiv[c], fmaf(fiv[i], xrv[c], ai[i][c]));
        }
    }
    const int64_t row = (r0 + b) * N;
    if (kArm == kF32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t o = row + (4 * kg + i) * Q + 4 * jg;
        *reinterpret_cast<float4*>(yr + o) =
            make_float4(ar[i][0], ar[i][1], ar[i][2], ar[i][3]);
        *reinterpret_cast<float4*>(yi + o) =
            make_float4(ai[i][0], ai[i][1], ai[i][2], ai[i][3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int w = (4 * kg + i) * Q + 4 * jg;
        const float4 wr4 = __ldg(reinterpret_cast<const float4*>(twr + w));
        const float4 wi4 = __ldg(reinterpret_cast<const float4*>(twi + w));
        const float wrv[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
        const float wiv[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float tr = ar[i][c] * wrv[c] - ai[i][c] * wiv[c];
          ai[i][c] = ar[i][c] * wiv[c] + ai[i][c] * wrv[c];
          ar[i][c] = tr;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t o = row + (4 * jg + c) * P + 4 * kg;
        *reinterpret_cast<float4*>(yr + o) =
            make_float4(ar[0][c], ar[1][c], ar[2][c], ar[3][c]);
        *reinterpret_cast<float4*>(yi + o) =
            make_float4(ai[0][c], ai[1][c], ai[2][c], ai[3][c]);
      }
    }
  }
}

template <int kArm, int P, int Q>
__device__ __forceinline__ void stage_mma(const float* X, const uint4* frag,
                                          float* __restrict__ yr,
                                          float* __restrict__ yi, int64_t r0,
                                          int nr) {
  constexpr int N = P * Q, XS = P * (Q + kPadX), MT = P / 16, KT = P / 16;
  constexpr int NT = Q / 8, NM = kArm == kPs ? 4 : 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int task = warp; task < nr * NT; task += kWarps) {
    const int b = task / NT;
    const int nt = task - b * NT;
    const float* Xr = X + 2 * b * XS + nt * 8 + gid;
    const float* Xi = Xr + XS;
    float cr[MT][4], ci[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) cr[m][c] = ci[m][c] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      // B fragment: rows j1, j1 + 1 and j1 + 8, j1 + 9 of column nt*8 + gid
      const int j1 = kt * 16 + tig * 2;
      const int s0 = j1 * (Q + kPadX), s1 = s0 + (Q + kPadX),
                s8 = s0 + 8 * (Q + kPadX), s9 = s8 + (Q + kPadX);
      uint32_t brh[2], bih[2], brl[2], bil[2];
      split2(Xr[s0], Xr[s1], &brh[0], kArm == kPs ? &brl[0] : nullptr);
      split2(Xr[s8], Xr[s9], &brh[1], kArm == kPs ? &brl[1] : nullptr);
      split2(Xi[s0], Xi[s1], &bih[0], kArm == kPs ? &bil[0] : nullptr);
      split2(Xi[s8], Xi[s9], &bih[1], kArm == kPs ? &bil[1] : nullptr);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint4* f = frag + (m * KT + kt) * NM * 32 + lane;
        const uint4 frh = f[0];
        const uint4 fih = f[32];
        const uint4 nfih = neg_bf16x8(fih);
        mma_bf16(cr[m], frh, brh);
        mma_bf16(cr[m], nfih, bih);
        mma_bf16(ci[m], fih, brh);
        mma_bf16(ci[m], frh, bih);
        if (kArm == kPs) {
          const uint4 frl = f[64];
          const uint4 fil = f[96];
          mma_bf16(cr[m], frh, brl);
          mma_bf16(cr[m], frl, brh);
          mma_bf16(cr[m], nfih, bil);
          mma_bf16(cr[m], neg_bf16x8(fil), bih);
          mma_bf16(ci[m], fih, brl);
          mma_bf16(ci[m], fil, brh);
          mma_bf16(ci[m], frh, bil);
          mma_bf16(ci[m], frl, bih);
        }
      }
    }
    // accumulator (row k1, columns j2, j2 + 1) -> y[k1 * q + j2]
    const int64_t row = (r0 + b) * N + nt * 8 + tig * 2;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int64_t o0 = row + (m * 16 + gid) * Q;
      const int64_t o8 = o0 + 8 * Q;
      *reinterpret_cast<float2*>(yr + o0) = make_float2(cr[m][0], cr[m][1]);
      *reinterpret_cast<float2*>(yr + o8) = make_float2(cr[m][2], cr[m][3]);
      *reinterpret_cast<float2*>(yi + o0) = make_float2(ci[m][0], ci[m][1]);
      *reinterpret_cast<float2*>(yi + o8) = make_float2(ci[m][2], ci[m][3]);
    }
  }
}

template <int kArm, int P, int Q>
__global__ void __launch_bounds__(kThreads, 1)
stage_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
             float* __restrict__ yr, float* __restrict__ yi,
             const float* __restrict__ consts, const float* __restrict__ twr,
             const float* __restrict__ twi, int rows, int rpb) {
  constexpr int XS = P * (Q + kPadX), TS = Q * (P + 1);
  constexpr int CF = const_floats<kArm, P>();
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* X = cs + CF;
  for (int i = threadIdx.x; i < CF / 4; i += kThreads)
    reinterpret_cast<float4*>(cs)[i] =
        __ldg(reinterpret_cast<const float4*>(consts) + i);
  const int groups = (rows + rpb - 1) / rpb;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(g) * rpb;
    const int nr = rows - r0 < rpb ? static_cast<int>(rows - r0) : rpb;
    __syncthreads();  // the constants are in; the previous group is done
    move_rows<true, P, Q>(xr, xi, yr, yi, X, r0, nr);
    __syncthreads();
    if (kArm == kIdentity) {
      move_rows<false, P, Q>(xr, xi, yr, yi, X, r0, nr);
    } else if (kArm == kRoundtrip) {
      // (p, q) -> (q, p): read down the columns of X (j1 fastest), write
      // the rows of T; then back, reading down the columns of T
      float* T = X + rpb * 2 * XS;
      for (int i = threadIdx.x; i < nr * 2 * P * Q; i += kThreads) {
        const int pl = i / (P * Q);
        const int t = i - pl * P * Q;
        const int j1 = t % P, j2 = t / P;
        T[pl * TS + j2 * (P + 1) + j1] = X[pl * XS + j1 * (Q + kPadX) + j2];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nr * 2 * P * Q; i += kThreads) {
        const int pl = i / (P * Q);
        const int t = i - pl * P * Q;
        const int j2 = t % Q, j1 = t / Q;
        X[pl * XS + j1 * (Q + kPadX) + j2] = T[pl * TS + j2 * (P + 1) + j1];
      }
      __syncthreads();
      move_rows<false, P, Q>(xr, xi, yr, yi, X, r0, nr);
    } else if (kArm == kF32 || kArm == kTwPerm) {
      stage_f32<kArm, P, Q>(X, cs, yr, yi, twr, twi, r0, nr);
    } else {
      stage_mma<kArm, P, Q>(X, reinterpret_cast<const uint4*>(cs), yr, yi,
                            r0, nr);
    }
  }
}

template <int kArm, int P, int Q>
int smem_bytes(int rpb) {
  const int x = rpb * 2 * P * (Q + kPadX);
  const int t = kArm == kRoundtrip ? rpb * 2 * Q * (P + 1) : 0;
  return static_cast<int>(sizeof(float)) *
         (const_floats<kArm, P>() + x + t);
}

template <int kArm, int P, int Q>
int run(bool launch, const float* xr, const float* xi, float* yr, float* yi,
        const float* consts, const float* twr, const float* twi, int rows,
        int rpb, int grid, int smem, cudaStream_t stream,
        int* blocks_per_sm) {
  if (smem != smem_bytes<kArm, P, Q>(rpb) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!launch) {
    cudaError_t err = cudaFuncSetAttribute(
        stage_kernel<kArm, P, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, stage_kernel<kArm, P, Q>, kThreads,
        static_cast<size_t>(smem)));
  }
  stage_kernel<kArm, P, Q><<<grid, kThreads, static_cast<size_t>(smem),
                             stream>>>(xr, xi, yr, yi, consts, twr, twi, rows,
                                       rpb);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int Q>
int dispatch_arm(int arm, bool launch, const float* xr, const float* xi,
                 float* yr, float* yi, const float* consts, const float* twr,
                 const float* twi, int rows, int rpb, int grid, int smem,
                 cudaStream_t stream, int* blocks_per_sm) {
#define STAGE_ARM(A)                                                       \
  case A:                                                                  \
    return run<A, P, Q>(launch, xr, xi, yr, yi, consts, twr, twi, rows,   \
                        rpb, grid, smem, stream, blocks_per_sm);
  switch (arm) {
    STAGE_ARM(kIdentity)
    STAGE_ARM(kRoundtrip)
    STAGE_ARM(kF32)
    STAGE_ARM(kTwPerm)
    STAGE_ARM(kPs)
    STAGE_ARM(kBf16)
  }
#undef STAGE_ARM
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int arm, int p, bool launch, const float* xr, const float* xi,
             float* yr, float* yi, const float* consts, const float* twr,
             const float* twi, int rows, int rpb, int grid, int smem,
             cudaStream_t stream, int* blocks_per_sm) {
  if (rpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 64)
    return dispatch_arm<64, 64>(arm, launch, xr, xi, yr, yi, consts, twr,
                                twi, rows, rpb, grid, smem, stream,
                                blocks_per_sm);
  if (p == 128)
    return dispatch_arm<128, 16>(arm, launch, xr, xi, yr, yi, consts, twr,
                                 twi, rows, rpb, grid, smem, stream,
                                 blocks_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

// The entry points act on the caller's current device; the caller sets it.
// Each returns the CUDA error code, 0 on success.  p = 64 runs n = 4096
// (q = 64), p = 128 runs n = 2048 (q = 16).

// Allow arm `arm` at `p` kMaxSmem bytes of dynamic shared memory and report
// how many blocks of `smem` bytes fit on one SM.
extern "C" int stage4096_occupancy(int arm, int p, int rpb, int smem,
                                   int* blocks_per_sm) {
  return dispatch(arm, p, false, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, 0, rpb, 0, smem, nullptr,
                  blocks_per_sm);
}

// (rows, p * q) split planes, 16-byte aligned, in groups of rpb rows;
// consts: Fr and Fi as p x p floats (arms 2, 3) or the A fragments (arms 4,
// 5); twr, twi: the (p, q) twiddle planes (arm 3).  smem = 4 * (constants
// + rpb * 2 * p * (q + 4) [+ rpb * 2 * q * (p + 1) for arm 1]) bytes.
extern "C" int stage4096_launch(const float* xr, const float* xi, float* yr,
                                float* yi, const float* consts,
                                const float* twr, const float* twi, int rows,
                                int p, int arm, int rpb, int grid, int smem,
                                void* stream) {
  return dispatch(arm, p, true, xr, xi, yr, yi, consts, twr, twi, rows, rpb,
                  grid, smem, static_cast<cudaStream_t>(stream), nullptr);
}
