// E6, E9, E11 and E12 at n = 1024 [64, 16]: K1 with each stage as the
// stacked product G [Xr; Xi], G = [[Fr, -Fi], [Fi, Fr]], on the tensor
// cores.  Timing-only kernels on split (rows, 1024) f32 planes, hand-
// written for Hopper (sm_90a), body in k1_mma.cuh.  Nothing on a user's
// path reaches them.
//
// Replaces the TPU measurement scripts experiments/stacked_kernel.py
// (make_stacked :19, pallas_call :121: hh + the fused cross pass),
// experiments/mono_stage.py (make_mono :55, pallas_call :118: one K = 6p
// pass; bf16perm splits before the permute), experiments/presplit_g.py
// (make_presplit :147, pallas_call :163: G split on the host, the fused
// cross on both stages or the first only; prod_k2first is
// pallas_stockham's in-kernel split at k2 = "first") and
// experiments/precision_variants.py (make_kernel :30, pallas_call :147:
// prod, blockdiag, noxl).  Variants: 0 fused / fused (E6, E11
// presplit_k2s2 and prod_k2all, E12 prod), 1 mono / mono, 2 mono / mono
// through the bf16 hi/lo buffer, 3 fused / three passes (E11's k2first
// arms), 4 noxl / noxl, 5 fused / fused with stage 2 packed
// block-diagonally (r = 4).  Where G is split is a run-time flag.
//
// What bounds them on an H100: 16 bytes of HBM a point, 0.120 ms at B =
// 24576; the products take 24p flops a point a stage (16p noxl), 24 (64 +
// 16) a point in all, 0.049 ms at 989 TFLOP/s (0.078 ms packed).  The
// design: Fr and Fi only, as A fragments in shared memory (-Fi a sign-bit
// flip), 34 KB; four 16-row tiles of a stage-1 column in one task, so each
// B fragment is split once for 16 (fused) MMAs; the bf16 buffer hands
// stage 2 its B fragments as 32-bit words with no split.

#include "k1_mma.cuh"

namespace fftw3_tpu_torch {
namespace {

using namespace fftw3_tpu_torch::k1mma;

int dispatch(int variant, bool launch, const Args& a, int grid, int smem,
             cudaStream_t stream, int* blocks_per_sm) {
#define K1S(V, G1, G2, BF, PK)                                              \
  case V:                                                                   \
    return run<kStacked, 64, G1, G2, BF, PK, kNone>(launch, a, grid, smem,  \
                                                    stream, blocks_per_sm);
  switch (variant) {
    K1S(0, kFused, kFused, false, false)
    K1S(1, kMono, kMono, false, false)
    K1S(2, kMono, kMono, true, false)
    K1S(3, kFused, kThree, false, false)
    K1S(4, kNoxl, kNoxl, false, false)
    K1S(5, kFused, kFused, false, true)
  }
#undef K1S
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

K1_MMA_ENTRY_POINTS(k1_mma_stacked64, dispatch)
