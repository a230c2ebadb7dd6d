// Host interface of the FFN backward's two-product kernel
// (ffn_block_bwd_wgmma.cu), which ffn_block_bwd.cu chains.
#pragma once

#include "gemm_wgmma.cuh"

namespace smm {

// Which FFN backwards take the wgmma chain: bf16 at E in multiples of 64 and
// F in multiples of 128, the kernel's tile (every base-width site; E at most
// 1024 is the wrapper's own limit), with 16-byte aligned operands, which the
// wrapper sees to. f32, the tiny preset's widths and other F keep the chain
// of gemm.cuh's kernels. ops/hopper/ffn_block.py asks it through
// smm_ffn_bwd_route to size its buffers.
inline bool ffn_bwd_wgmma_takes(bool is_bf16, int E, int F) {
  return is_bf16 && E > 0 && F > 0 && E % 64 == 0 && F % 128 == 0 && E <= 1024;
}

// Over [M, F], with K = E:
//   hpre = a . w1t^T + b1               (a [M, E]: xn or x; w1t [F, E], torch layout)
//   h    = drop_mid(gelu_tanh(hpre))    -> h [M, F] bf16, unless h is null
//   dhp  = gelu_tanh'(hpre) * drop_mid(dy0 . w2t)   (dy0 [M, E]; w2t [E, F], torch layout)
//                                       -> dhp [M, F] bf16
//   part[i, c] = sum of the bf16-rounded dhp over rows 128 i .. 128 i + 127
//                                       -> part [ceil(M / 128), F] f32
// mid: the intermediate's FFN dropout (salt kSaltMid, rows of S tokens).
// Returns the first CUDA error, or 0.
int ffn_bwd_wgmma_launch(const bf16* a, const bf16* dy0, const bf16* w1t, const bf16* b1,
                         const bf16* w2t, int M, int E, int F, int S, Drop mid, bf16* h,
                         bf16* dhp, float* part, cudaStream_t st);

}  // namespace smm
