// Flash attention backward on wgmma, the dq kernel (bf16, head widths 64,
// 96, 128): dq = ds k / sqrt(D) and, with a bias gradient, the f32 score
// gradient dS [B, H, Sq, Sk].
//
// Replaces simple_multimodal_tpu/ops/pallas/flash_attention.py,
// `_bwd_dq_kernel` via `_flash_backward`, for the widths the long-clip path
// uses; the arithmetic is that of flash_attention_bwd.cu (p recomputed from
// the saved row maximum and sum, ds = p (dp - delta), ds rounded to bf16
// before it meets k). The shared design is in flash_attention_wgmma.cuh.
//
// What bounds it on this card: operations (three products, 6 Sq Sk D FLOP
// per (batch, head)); with a bias gradient, the dS write (4 B H Sq Sk
// bytes). What the design does about it: a block of two consumer
// warpgroups and a producer warpgroup owns 128 query rows with Q and dO resident
// in shared memory; per 64-key tile S = q.k^T and dP = dout.v^T are two
// m64n64k16 chains issued together, dS is formed on the accumulator
// registers and goes back in as the A registers of dq += ds.k with the K
// tile as an MN-major B operand; dq stays in registers until the store.

#include "flash_attention_bwd_dq_wgmma.cuh"

namespace smm {
namespace {

using namespace flashw::dq;

template <int D>
int launch_dq_d(const FlashBwdArgs& a, int B, cudaStream_t st) {
  const Drop none{nullptr, 0, 1.0f};
  return a.f.bias ? launch_dq<D, true, false>(a, none, B, st)
                  : launch_dq<D, false, false>(a, none, B, st);
}

}  // namespace

int flash_bwd_dq_wgmma_launch(const FlashBwdArgs& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch_dq_d<64>(a, B, st);
    case 96: return launch_dq_d<96>(a, B, st);
    case 128: return launch_dq_d<128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_bwd_dq_wgmma_smem(int D) {
  return D == 64 ? DqPlan<64>::bytes : D == 96 ? DqPlan<96>::bytes : D == 128 ? DqPlan<128>::bytes : 0;
}

}  // namespace smm
