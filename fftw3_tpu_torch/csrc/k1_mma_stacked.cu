// E10 and E12 at n = 1024 [32, 32] and [128, 8]: K1 with each stage as the
// stacked product G [Xr; Xi] on the tensor cores.  Timing-only kernels on
// split (rows, 1024) f32 planes, hand-written for Hopper (sm_90a), body in
// k1_mma.cuh.  Nothing on a user's path reaches them.
//
// Replaces the TPU measurement scripts experiments/headline_gap.py
// (make_repeat_call :46, pallas_call :82: the shipping presplit stages
// run r times in one kernel; _stages' presplit branch fuses the cross pass
// on every stage that fits K2_MAX_BYTES, both here) and
// experiments/precision_variants.py (make_kernel :30, pallas_call :147:
// prod and blockdiag at the [32, 32] and [128, 8] schedules).  Variants:
// 0 [32, 32] fused / fused (E12 prod; E10 with G split on the host and a
// run-time repeat count), 1 the same packed block-diagonally (r = 2 on
// both stages), 2 [128, 8] fused / fused, 3 the same with stage 2 packed
// (r = 8).
//
// What bounds them on an H100: 16 bytes of HBM a point, 0.120 ms at B =
// 24576 (0.080 at E10's 16384, where r passes add no bytes); the products
// take 24p flops a point a stage, 0.039 ms at [32, 32] and 0.083 at
// [128, 8] at 989 TFLOP/s (r-fold packed: 0.078, 0.117).  The design: at
// p = 128 the Fr/Fi hi/lo fragments take 128 KB of shared memory, so that
// schedule runs one block an SM and at most four rows a block (a copy read
// through L1 would serve only a host split, which no [128, 8] arm of the
// reference has); at p = 8 the stacked G is one 16 x 16 A tile.

#include "k1_mma.cuh"

namespace fftw3_tpu_torch {
namespace {

using namespace fftw3_tpu_torch::k1mma;

int dispatch(int variant, bool launch, const Args& a, int grid, int smem,
             cudaStream_t stream, int* blocks_per_sm) {
#define K1S(V, P1, PK)                                                    \
  case V:                                                                 \
    return run<kStacked, P1, kFused, kFused, false, PK, kNone>(           \
        launch, a, grid, smem, stream, blocks_per_sm);
  switch (variant) {
    K1S(0, 32, false)
    K1S(1, 32, true)
    K1S(2, 128, false)
    K1S(3, 128, true)
  }
#undef K1S
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

K1_MMA_ENTRY_POINTS(k1_mma_stacked, dispatch)
