// The GEMM epilogue contract shared by every GEMM kernel of the port, and
// the host interface of the wgmma/TMA GEMM (gemm_wgmma.cu). gemm.cuh includes
// this file and routes bf16 products here by shape; only gemm_wgmma.cu
// compiles the kernel.
//
//   out[M, N] = drop(act(A[M, K] . W[N, K]^T + bias)) (+ res)
#pragma once

#include "common.cuh"

namespace smm {

struct Epilogue {
  const void* bias;  // [N] in the input type, or null
  const void* res;   // [M, ldr] in the input type (f32 with res_f32), or null
  int ldr;
  void* out;  // [M, ldc]
  int ldc;
  int act;      // Act
  int out_f32;  // 1: store f32, 0: store the input type
  int res_f32;
  // FFN dropout over (b, s, c) = (r / drop_S, r % drop_S, c), with the
  // seed + salt of the site; off when drop.seed is null
  Drop drop;
  int salt;
  int drop_S;
  const float* aux;  // [M, ldc] pre-activation for ACT_DGELU_*
};

inline bool ptr_aligned(const void* p, uintptr_t bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

// Which bf16 products the wgmma kernel takes: a choice by shape and
// alignment, made before anything is launched. TMA needs 16-byte aligned
// bases and row strides; the kernel walks K in steps of 64 and N in tiles of
// 64 or 128 without a ragged edge; its epilogue reads and writes column
// pairs (4-byte bf16 pairs, 8-byte f32 pairs). Everything else (the tiny
// preset's widths, an odd view) runs the WMMA kernel of gemm.cuh.
inline bool gemm_wgmma_takes(const void* A, int lda, const void* W, int ldw, int N, int K,
                             const Epilogue& ep) {
  return N > 0 && K > 0 && N % 64 == 0 && K % 64 == 0 && lda % 8 == 0 && ldw % 8 == 0 &&
         ptr_aligned(A, 16) && ptr_aligned(W, 16) && ep.ldc % 2 == 0 &&
         ptr_aligned(ep.out, 8) && ptr_aligned(ep.bias, 4) &&
         (!ep.res || (ep.ldr % 2 == 0 && ptr_aligned(ep.res, 8))) && ptr_aligned(ep.aux, 8);
}

// Columns of the block tile (128 or 64) the wgmma kernel uses for an
// [M, N] output whose weights come in groups of `group_n` columns.
int gemm_wgmma_tile_n(int M, int N, int group_n);

// out = epilogue(A . [W_0; ...; W_{groups-1}]^T): `groups` (1..3) weights of
// [group_n, K] each, with their biases (ep.bias is not read), write
// neighbouring column blocks of one [M, groups * group_n] output, so the
// q|k|v projections are one launch with no concatenated weight. The caller
// has checked gemm_wgmma_takes for every weight with N = group_n. Returns
// the first CUDA error, or 0.
int gemm_wgmma_launch(const bf16* A, int lda, const bf16* const* W, int ldw,
                      const void* const* bias, int groups, int M, int group_n, int K,
                      const Epilogue& ep, cudaStream_t st);

// Dynamic shared memory (bytes) of the kernel with a tile of `tile_n` columns.
int gemm_wgmma_smem(int tile_n);

}  // namespace smm
