// Fused transformer FFN block for Hopper: [pre-LN ->] x W1 + b1 -> GELU
// [-> drop] -> W2 + b2 [-> drop] [+ x] [-> post-LN].
//
// Replaces simple_multimodal_tpu/ops/pallas/ffn_block.py, `_kernel` via
// `_fused_call` (forward). The TPU kernel keeps a row tile's [R, F]
// intermediate in VMEM; here the block is a chain of launches on one
// stream: an optional pre-LN row kernel, GEMM1 with a bias + GELU
// epilogue (erf for f32, tanh for bf16), GEMM2 with a bias + residual
// epilogue, and an optional post-LN row kernel. The two hash dropouts
// (salt 1 after the GELU, salt 2 on the output before the residual) run in
// the GEMM epilogues in f32, before the rounding to the compute type, over
// (b, s, column) with b = row / S, s = row % S. Before a post-LN the GEMM2
// sum is kept in f32, as the reference normalises the f32 sum.
// What bounds it here: both GEMMs are tensor-core bound at the main path's
// row counts (4k-47k rows, E=768, F=3072). In this version the [rows, F]
// intermediate round-trips device memory (written by GEMM1, read by
// GEMM2): ~2 x rows x F x 2 bytes per call in bf16. Keeping it on chip,
// and wgmma/TMA, is later work.

#include "gemm.cuh"

namespace {

using namespace smm;

template <typename T>
int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
        const void* ln_g, const void* ln_b, float eps, int ln_mode, int residual, int M, int E,
        int F, int S, Drop mid, Drop outd, void* xn, void* h, void* y32, void* out,
        cudaStream_t st) {
  const T* a = (const T*)x;
  if (ln_mode == 1) {
    if (int e = launch_layernorm<T, T>((const T*)x, (const T*)ln_g, (const T*)ln_b, (T*)xn, M, E,
                                       eps, st))
      return e;
    a = (const T*)xn;
  }
  const int act = sizeof(T) == 2 ? ACT_GELU_TANH : ACT_GELU_ERF;
  Epilogue ep1{b1, nullptr, 0, h, F, act, 0, 0, mid, kSaltMid, S};
  if (int e = launch_gemm(a, E, (const T*)w1, E, M, F, E, ep1, st)) return e;
  const void* res = residual ? x : nullptr;
  if (ln_mode == 2) {
    Epilogue ep2{b2, res, E, y32, E, ACT_NONE, 1, 0, outd, kSaltOut, S};
    if (int e = launch_gemm((const T*)h, F, (const T*)w2, F, M, E, F, ep2, st)) return e;
    return launch_layernorm<float, T>((const float*)y32, (const T*)ln_g, (const T*)ln_b, (T*)out,
                                      M, E, eps, st);
  }
  Epilogue ep2{b2, res, E, out, E, ACT_NONE, 0, 0, outd, kSaltOut, S};
  return launch_gemm((const T*)h, F, (const T*)w2, F, M, E, F, ep2, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. ln_mode: 0 none, 1 pre-LN, 2 post-LN.
// w1 [F, E], w2 [E, F] in torch Linear layout; rows M = B*S. seed: device
// int32 [1] or null; each dropout is (thresh, scale, on). xn [M, E]
// (pre-LN), h [M, F] and y32 [M, E] f32 (post-LN) are caller-allocated
// scratch. Returns the first CUDA error, or 0.
extern "C" int smm_ffn_block(int dtype, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* ln_g, const void* ln_b,
                             float eps, int ln_mode, int residual, int M, int E, int F, int S,
                             const int* seed, unsigned thresh_mid, float scale_mid, int on_mid,
                             unsigned thresh_out, float scale_out, int on_out, void* xn, void* h,
                             void* y32, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop mid{on_mid ? seed : nullptr, thresh_mid, scale_mid};
  const Drop outd{on_out ? seed : nullptr, thresh_out, scale_out};
  if (dtype == 1)
    return run<bf16>(x, w1, b1, w2, b2, ln_g, ln_b, eps, ln_mode, residual, M, E, F, S, mid, outd,
                     xn, h, y32, out, st);
  return run<float>(x, w1, b1, w2, b2, ln_g, ln_b, eps, ln_mode, residual, M, E, F, S, mid, outd,
                    xn, h, y32, out, st);
}
