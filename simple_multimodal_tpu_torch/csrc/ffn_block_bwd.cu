// Backward of the fused transformer FFN block for Hopper.
//
// Replaces simple_multimodal_tpu/ops/pallas/ffn_block.py, `_bwd_kernel` via
// `_ffn_bwd` (opt-in there; on the port's main path). From the saved
// inputs alone it recomputes LN -> h_pre = xn W1 + b1 (kept in f32), the
// dropped GELU h, and for post-LN the sum y0 = h W2 + b2 -> drop -> + x and
// the output-LN backward; replays both hash masks; computes
// dh_pre = GELU'(h_pre) * mask_mid * (dy0 . W2^T) in the dh GEMM's
// epilogue and dxn = dh_pre . W1^T; then the pre-LN backward with the
// residual added (dx, dgamma, dbeta, the latter summed per block and then
// over blocks in a fixed order). GELU' is the derivative of the GELU the
// forward uses: erf in f32, tanh in bf16. The weight gradients
// (dW1 = xn^T dh_pre, dW2 = h^T dy0 and the bias sums) are matmuls outside,
// as in the JAX `_ffn_bwd`, fed by the h, dy0 and dh_pre this chain
// returns.
//
// What bounds it here: four tensor-core GEMMs (two recomputing the
// forward, dh and dxn), each rows x E x F; the [rows, F] h_pre (f32), h and
// dh_pre round-trip device memory (~8 bytes per element more than a fused
// version would move), which keeping dh_pre tiles on chip between the dh
// and dxn GEMMs would save. That, and wgmma/TMA, is later work.

#include "gemm.cuh"

namespace {

using namespace smm;

template <typename T>
int run(const void* x, const void* gy, const void* w1t, const void* b1, const void* w2t,
        const void* b2, const void* w1f, const void* w2f, const void* ln_g, const void* ln_b,
        float eps, int ln_mode, int residual, int M, int E, int F, int S, Drop mid, Drop outd,
        void* xn, float* hpre, void* h, float* y32, void* dy0, void* dhp, float* dxn, void* dx,
        float* part, float* dln, cudaStream_t st) {
  const int act = sizeof(T) == 2 ? ACT_GELU_TANH : ACT_GELU_ERF;
  const T* in = (const T*)x;
  if (ln_mode == 1) {
    if (int e = launch_layernorm<T, T>((const T*)x, (const T*)ln_g, (const T*)ln_b, (T*)xn, M, E,
                                       eps, st))
      return e;
    in = (const T*)xn;
  }
  {  // h_pre = in . W1 + b1 (f32)
    Epilogue ep{b1, nullptr, 0, hpre, F, ACT_NONE, 1};
    if (int e = launch_gemm(in, E, (const T*)w1t, E, M, F, E, ep, st)) return e;
  }
  const size_t nf = (size_t)M * F, ne = (size_t)M * E;
  gelu_drop_kernel<T><<<elementwise_grid(nf), 256, 0, st>>>(hpre, (T*)h, M, F, act, mid,
                                                              kSaltMid, S);
  SMM_CHECK_LAUNCH();
  if (ln_mode == 2) {
    // ysum = drop(h . W2 + b2) [+ x] in f32, then the output-LN backward
    // in place: y32 becomes dysum
    Epilogue ep{b2, residual ? x : nullptr, E, y32, E, ACT_NONE, 1, 0, outd, kSaltOut, S};
    if (int e = launch_gemm((const T*)h, F, (const T*)w2t, F, M, E, F, ep, st)) return e;
    if (int e = launch_ln_bwd<T, T, float, T, float>((const T*)gy, y32, (const T*)ln_g, eps, M, E,
                                                     (const T*)nullptr, y32, part, dln, st))
      return e;
    drop_cast_kernel<float, T><<<elementwise_grid(ne), 256, 0, st>>>(y32, (T*)dy0, M, E, outd,
                                                                      kSaltOut, S);
  } else {
    drop_cast_kernel<T, T><<<elementwise_grid(ne), 256, 0, st>>>((const T*)gy, (T*)dy0, M, E,
                                                                  outd, kSaltOut, S);
  }
  SMM_CHECK_LAUNCH();
  {  // dh_pre = GELU'(h_pre) * mask_mid * (dy0 . W2^T); flax W2 [F, E] is K-major
    Epilogue ep{nullptr, nullptr, 0, dhp, F, act + 2, 0, 0, mid, kSaltMid, S, hpre};
    if (int e = launch_gemm((const T*)dy0, E, (const T*)w2f, E, M, F, E, ep, st)) return e;
  }
  // dxn = dh_pre . W1^T; flax W1 [E, F] is K-major
  if (ln_mode == 1) {
    Epilogue ep{nullptr, nullptr, 0, dxn, E, ACT_NONE, 1};
    if (int e = launch_gemm((const T*)dhp, F, (const T*)w1f, F, M, E, F, ep, st)) return e;
    return launch_ln_bwd<T, float, T, T, T>(dxn, (const T*)x, (const T*)ln_g, eps, M, E,
                                            residual ? (const T*)gy : nullptr, (T*)dx, part, dln,
                                            st);
  }
  // post-LN: dx = dxn + dysum (residual); none: dx = dxn + gy (residual)
  const void* res = !residual ? nullptr : ln_mode == 2 ? (const void*)y32 : gy;
  Epilogue ep{nullptr, res, E, dx, E, ACT_NONE, 0, ln_mode == 2};
  return launch_gemm((const T*)dhp, F, (const T*)w1f, F, M, E, F, ep, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. ln_mode: 0 none, 1 pre-LN, 2 post-LN. w1t
// [F, E], w2t [E, F] in torch Linear layout (the forward's operands); w1f
// [E, F], w2f [F, E] in flax layout (the K-major operands of dxn and dh).
// Rows M = B*S. seed: device int32 [1] or null; each dropout is
// (thresh, scale, on). Outputs: xn [M, E] (pre-LN), h [M, F], dy0 [M, E],
// dhp [M, F], dx [M, E] and dln f32 [2, E] (with LN). Scratch: hpre f32
// [M, F], y32 f32 [M, E] (post-LN), dxn f32 [M, E] (pre-LN), part f32
// [blocks, 2E]. Returns the first CUDA error, or 0.
extern "C" int smm_ffn_block_bwd(int dtype, const void* x, const void* gy, const void* w1t,
                                 const void* b1, const void* w2t, const void* b2, const void* w1f,
                                 const void* w2f, const void* ln_g, const void* ln_b, float eps,
                                 int ln_mode, int residual, int M, int E, int F, int S,
                                 const int* seed, unsigned thresh_mid, float scale_mid,
                                 int on_mid, unsigned thresh_out, float scale_out, int on_out,
                                 void* xn, float* hpre, void* h, float* y32, void* dy0, void* dhp,
                                 float* dxn, void* dx, float* part, float* dln, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop mid{on_mid ? seed : nullptr, thresh_mid, scale_mid};
  const Drop outd{on_out ? seed : nullptr, thresh_out, scale_out};
  if (dtype == 1)
    return run<bf16>(x, gy, w1t, b1, w2t, b2, w1f, w2f, ln_g, ln_b, eps, ln_mode, residual, M, E,
                     F, S, mid, outd, xn, hpre, h, y32, dy0, dhp, dxn, dx, part, dln, st);
  return run<float>(x, gy, w1t, b1, w2t, b2, w1f, w2f, ln_g, ln_b, eps, ln_mode, residual, M, E, F,
                    S, mid, outd, xn, hpre, h, y32, dy0, dhp, dxn, dx, part, dln, st);
}
