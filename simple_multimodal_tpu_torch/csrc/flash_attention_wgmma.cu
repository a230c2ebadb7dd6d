// Flash attention forward on wgmma (bf16, head widths 64, 96, 128):
// out = softmax(q k^T / sqrt(D) + bias) v and each row's maximum and sum.
//
// Replaces simple_multimodal_tpu/ops/pallas/flash_attention.py, `_fwd_kernel`
// via `_flash_forward`, for the widths the long-clip path uses; the function
// and its conventions (finite -1e30 start of the running maximum, p rounded
// to bf16 before p.v, f32 sums, maximum and sum saved apart) are those of
// flash_attention.cu. The shared design is in flash_attention_wgmma.cuh.
//
// What bounds it on this card: operations, 4 Sq Sk D FLOP per (batch,
// head) on Sq D + 2 Sk D elements; with a full f32 bias, the bias's bytes
// (4 B H Sq Sk). What the design does about it: a block of two consumer
// warpgroups (64 query rows each) and a producer warpgroup owns 128 query
// rows, so each K/V tile read from L2 feeds 128 rows; S = q.k^T is one
// m64n{kKeys}k16 chain with Q and K from shared memory, the online softmax
// runs on the accumulator registers, P goes back in as the A registers of
// O += p.v with the V tile as an MN-major B operand, and O stays in
// registers, rescaled in place, until the store. (Leaving a tile's p.v in
// flight while the next tile's q.k^T is issued made ptxas serialize the
// wgmma pipeline at D = 96 for lack of registers, and cost the two backward
// kernels time: each tile's products are waited for before the next.) The bias is read from
// device memory straight in the accumulator layout (four lanes cover 8
// consecutive keys of a row: whole 32-byte sectors; its key stride is 1, the
// other three strides are free) and only when there is one (template).

#include "flash_attention_fwd_wgmma.cuh"

namespace smm {
namespace {

using namespace flashw;

template <int D>
int launch_fwd_d(const FlashArgs& a, const FlashOut& w, int B, cudaStream_t st) {
  const Drop none{nullptr, 0, 1.0f};
  return a.bias ? launch_fwd<D, true, false>(a, w, none, B, st)
                : launch_fwd<D, false, false>(a, w, none, B, st);
}

}  // namespace

int flash_fwd_wgmma_launch(const FlashArgs& a, const FlashOut& w, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch_fwd_d<64>(a, w, B, st);
    case 96: return launch_fwd_d<96>(a, w, B, st);
    case 128: return launch_fwd_d<128>(a, w, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_fwd_wgmma_smem(int D) {
  return D == 64 ? FwdPlan<64>::bytes : D == 96 ? FwdPlan<96>::bytes : D == 128 ? FwdPlan<128>::bytes : 0;
}

}  // namespace smm
