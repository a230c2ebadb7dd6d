// The attention core of attention_block on wgmma (bf16, head widths 64 and
// 128, the two of the block's widths that flash_attention's kernel has): softmax(q k^T / sqrt(D)) [hash dropout] v per head, with q, k
// and v read in place from the packed [rows, 3E] projection buffer through
// three-axis tensor maps (row stride 3E).
//
// Part of the forward that replaces
// simple_multimodal_tpu/ops/pallas/attention_block.py, `_kernel` via
// `_fused_call`. The kernel is flash_attention's forward
// (flash_attention_fwd_wgmma.cuh; design note in flash_attention_wgmma.cu):
// 128 query rows a block, K/V tiles through a TMA ring, scores and
// probabilities in accumulator registers, P packed as the A registers of
// P.V. What attention_block adds is the dropout of the probabilities,
// hash_keep(seed, b H + h, q, k): formed in the accumulator layout (the row
// part of the hash once per row) after the row sum of ALL exponentials and
// before the bf16 rounding, so the result is normalised by the pre-dropout
// sum as attention.cuh does and the mask is bit-equal to it and to
// ops/hopper/dropout.py. Serving runs flash_attention's own instantiation
// (no dropout compiled in); only the training variant is compiled here,
// with key tiles of 64 (128 scores a row beside the hash made ptxas spill).
// The backward re-runs this core for the context and, asked through
// FlashOut.m and .l, each row's maximum and sum (attention_block_bwd.cu).
// Other head widths, f32 and deberta_attention's forward keep attention.cuh.

#include "flash_attention_fwd_wgmma.cuh"

namespace smm {

int attention_core_wgmma_launch(const FlashArgs& a, const FlashOut& w, const Drop& drop, int B,
                                int D, cudaStream_t st) {
  if (!drop.seed) return flash_fwd_wgmma_launch(a, w, B, D, st);
  switch (D) {
    case 64: return flashw::launch_fwd<64, false, true>(a, w, drop, B, st);
    case 128: return flashw::launch_fwd<128, false, true>(a, w, drop, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int attention_core_wgmma_smem(int D) {
  return D == 64 ? flashw::FwdPlan<64, true>::bytes
                 : D == 128 ? flashw::FwdPlan<128, true>::bytes : 0;
}

}  // namespace smm
