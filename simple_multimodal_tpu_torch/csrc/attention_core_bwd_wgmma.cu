// The backward core of attention_block on wgmma (bf16, head widths 64 and
// 128): dq, dk and dv of softmax(q k^T / sqrt(D)) [hash dropout] v per head,
// with q, k, v read in place from the packed [rows, 3E] projection buffer,
// dout from the [rows, E] gradient of the context, and dq | dk | dv written
// into the packed [rows, 3E] buffer the dxn GEMM reads (three-axis tensor
// maps with the buffers' own row strides; no copy).
//
// Part of the backward that replaces
// simple_multimodal_tpu/ops/pallas/attention_block.py, `_bwd_kernel` via
// `_block_bwd`. The kernels are flash_attention's backward pair
// (flash_attention_bwd_dq_wgmma.cuh, flash_attention_bwd_dkv_wgmma.cuh; the
// design notes are in the .cu files of the same names): scores and dp by
// wgmma, p re-formed on the accumulator registers from the row maximum and
// sum that the wgmma forward core wrote in its re-run, ds and the dropped
// probabilities packed as the A registers of the next products. What
// attention_block adds is the replayed dropout, hash_keep(seed, b H + h, q,
// k), formed in the accumulator layout: in the dq kernel a row is a query
// (the row part of the hash once per row), in the dk/dv kernel a row is a
// key and the columns are queries, so the roles swap. The order is that of
// attention_bwd.cuh's `ds_elem`: p~ = keep p / (1 - rate) feeds dv,
// ds = p (keep dp / (1 - rate) - delta) / sqrt(D) feeds dq and dk, with
// delta = rowsum(dout . ctx) of the dropped context. The mask is bit-equal
// to attention.cuh's and to ops/hopper/dropout.py. Without dropout the
// block runs flash_attention's own instantiations; only the dropout
// variants are compiled here.
//
// What bounds it on this card: operations (7 products of S S D per head,
// two of them computed in both kernels). Keys past S get p = 0 and rows past
// S are never stored (S = 197 and 499 are no multiples of the 64-row tiles).

#include "flash_attention_bwd_dkv_wgmma.cuh"
#include "flash_attention_bwd_dq_wgmma.cuh"

namespace smm {

int attention_core_bwd_wgmma_launch(const FlashBwdArgs& a, const Drop& drop, int B, int D,
                                    cudaStream_t st) {
  if (!drop.seed) {
    if (int e = flash_bwd_dq_wgmma_launch(a, B, D, st)) return e;
    return flash_bwd_dkv_wgmma_launch(a, B, D, st);
  }
  switch (D) {
    case 64:
      if (int e = flashw::dq::launch_dq<64, false, true>(a, drop, B, st)) return e;
      return flashw::dkv::launch_dkv<64, false, true>(a, drop, B, st);
    case 128:
      if (int e = flashw::dq::launch_dq<128, false, true>(a, drop, B, st)) return e;
      return flashw::dkv::launch_dkv<128, false, true>(a, drop, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace smm
