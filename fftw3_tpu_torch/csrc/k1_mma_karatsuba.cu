// E4, the Karatsuba stage form of K1 at n = 1024 [32, 32]: a timing-only
// kernel on split (rows, 1024) f32 planes, hand-written for Hopper
// (sm_90a), body in k1_mma.cuh.  Nothing on a user's path reaches it.
//
// Replaces the TPU measurement script experiments/kernel_variants.py
// (make_variant :22, kernel body :107, pallas_call :187): each stage's
// complex product as three real products t1 = Fr Xr, t2 = Fi Xi, t3 =
// (Fr + Fi)(Xr + Xi) (mm_pair :65-105), each bf16 hi/lo.  Variants, the
// reference's names: 0 baseline and fsplit (three passes a product, G
// split in the block's prologue or on the host), 1 k2 (the cross terms in
// one accumulator), 2-5 diag copy, notw, noperm, noperm-notw (:111-158).
// The reference's tw="lanes"/"flat" replicate the twiddle across the TPU's
// 128 lanes, tb its row tile, vmem100 its scoped-VMEM limit: here one
// (32, 32) twiddle table serves every form, so those variants are the
// control and have no instantiation of their own.
//
// What bounds it on an H100: 16 bytes of HBM a point, 0.120 ms at B =
// 24576; its products are 18p = 576 bf16 flops a point a stage, 0.029 ms
// at 989 TFLOP/s.  The design: F's fragments live in shared memory for the
// block's life, Xr + Xi is summed in f32 before its split as in the
// reference, and each B fragment is split once per task: a task takes
// both 16-row tiles of F at k2 (24 accumulator floats a tile) and one at
// three passes (36).

#include "k1_mma.cuh"

namespace fftw3_tpu_torch {
namespace {

using namespace fftw3_tpu_torch::k1mma;

int dispatch(int variant, bool launch, const Args& a, int grid, int smem,
             cudaStream_t stream, int* blocks_per_sm) {
#define K1K(V, G, D)                                                      \
  case V:                                                                 \
    return run<kKaratsuba, 32, G, G, false, false, D>(launch, a, grid,    \
                                                      smem, stream,       \
                                                      blocks_per_sm);
  switch (variant) {
    K1K(0, kThree, kNone)
    K1K(1, kFused, kNone)
    K1K(2, kThree, kCopy)
    K1K(3, kThree, kNoTw)
    K1K(4, kThree, kNoPerm)
    K1K(5, kThree, kNoPermNoTw)
  }
#undef K1K
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace fftw3_tpu_torch

using namespace fftw3_tpu_torch;

K1_MMA_ENTRY_POINTS(k1_mma_karatsuba, dispatch)
