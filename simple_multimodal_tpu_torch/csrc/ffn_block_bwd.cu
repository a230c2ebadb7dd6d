// Backward of the fused transformer FFN block for Hopper.
//
// Replaces simple_multimodal_tpu/ops/pallas/ffn_block.py, `_bwd_kernel` via
// `_ffn_bwd` (opt-in there; on the port's main path). From the saved
// inputs alone it recomputes LN -> h_pre = xn W1 + b1, the dropped GELU h,
// and for post-LN the sum y0 = h W2 + b2 -> drop -> + x and the output-LN
// backward; replays both hash masks; forms dh_pre = GELU'(h_pre) * mask_mid
// * (dy0 . W2^T) and dxn = dh_pre . W1^T; then the pre-LN backward with the
// residual added (dx, dgamma, dbeta). GELU' is the derivative of the GELU the
// forward uses: erf in f32, tanh in bf16. The weight gradients
// (dW1 = xn^T dh_pre, dW2 = h^T dy0) are matmuls outside, as in the JAX
// `_ffn_bwd`, fed by the h, dy0 and dh_pre this chain returns.
//
// What bounds it on this card: operations, four products of 2 rows E F
// each (two recomputing the forward, dh and dxn), and around them the
// [rows, F] intermediates' bytes. The route is chosen from the type and the
// widths before anything is launched (ffn_bwd_wgmma_takes):
// - bf16, E in multiples of 64, F of 128 (every base-width site): the wgmma
//   chain. The pre-activation never reaches device memory: one kernel
//   (ffn_block_bwd_wgmma.cu) computes xn W1 and dy0 W2^T over the same
//   [M, F] tile and leaves h, dh_pre and db1's per-strip partials; dy0 and
//   db2's partials come from one row pass (drop_cast_sum_kernel); the
//   LayerNorm backward keeps each row in registers (gemm.cuh); db1, db2 and
//   dgamma/dbeta are folds of partials in a fixed order. Pre-LN and no LN:
//   LN -> drop_cast_sum -> two products -> dxn GEMM -> LN backward. Post-LN:
//   dy0 needs y0 = h W2 first, so GEMM1 writes h (bf16), the y32 GEMM and the
//   output-LN backward follow, and the two-product kernel recomputes the
//   pre-activation beside dh (it stores no h: GEMM1's is the same).
// - f32 and the other widths: gemm.cuh's chain (an f32 h_pre [rows, F] from
//   the first GEMM, gelu_drop_kernel, the ACT_DGELU epilogue on the dh GEMM;
//   the bias gradients are summed by the wrapper).

#include "ffn_block_bwd_wgmma.cuh"
#include "gemm.cuh"

namespace {

using namespace smm;

// gemm.cuh's chain (f32, and bf16 at widths the wgmma chain does not take).
template <typename T>
int run_chain(const void* x, const void* gy, const void* w1t, const void* b1, const void* w2t,
              const void* b2, const void* w1f, const void* w2f, const void* ln_g,
              const void* ln_b, float eps, int ln_mode, int residual, int M, int E, int F, int S,
              Drop mid, Drop outd, void* xn, float* hpre, void* h, float* y32, void* dy0,
              void* dhp, float* dxn, void* dx, float* part, float* dln, cudaStream_t st) {
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
  {  // dh_pre = GELU'(h_pre) * mask_mid * (dy0 . W2); W2^T [F, E] is the K-major operand
    Epilogue ep{nullptr, nullptr, 0, dhp, F, act + 2, 0, 0, mid, kSaltMid, S, hpre};
    if (int e = launch_gemm((const T*)dy0, E, (const T*)w2f, E, M, F, E, ep, st)) return e;
  }
  // dxn = dh_pre . W1; W1^T [E, F] is the K-major operand
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

// The wgmma chain (bf16). part: the LayerNorm backward's [row_blocks(M),
// 2E], then db1's [ceil(M / 128), F], then db2's [row_blocks(M), E]; dsum:
// dln [2, E], db1 [F], db2 [E].
int run_wgmma(const bf16* x, const bf16* gy, const bf16* w1t, const bf16* b1, const bf16* w2t,
              const bf16* b2, const bf16* w1f, const bf16* ln_g, const bf16* ln_b, float eps,
              int ln_mode, int residual, int M, int E, int F, int S, Drop mid, Drop outd, bf16* xn,
              bf16* h, float* y32, bf16* dy0, bf16* dhp, float* dxn, bf16* dx, float* part,
              float* dsum, cudaStream_t st) {
  const int nb = row_blocks(M);
  float* part_b1 = part + (size_t)nb * 2 * E;
  float* part_b2 = part_b1 + (size_t)((M + 127) / 128) * F;
  float *dln = dsum, *db1 = dsum + 2 * E, *db2 = db1 + F;
  const bf16* a = x;
  if (ln_mode == 1) {
    if (int e = launch_layernorm<bf16, bf16>(x, ln_g, ln_b, xn, M, E, eps, st)) return e;
    a = xn;
  }
  if (ln_mode == 2) {
    // h = drop(gelu(x W1 + b1)), then ysum = drop(h W2 + b2) [+ x] in f32
    // and the output-LN backward in place: y32 becomes dysum
    const Epilogue e1{b1, nullptr, 0, h, F, ACT_GELU_TANH, 0, 0, mid, kSaltMid, S};
    if (int e = launch_gemm(x, E, w1t, E, M, F, E, e1, st)) return e;
    const Epilogue e2{b2, residual ? x : nullptr, E, y32, E, ACT_NONE, 1, 0, outd, kSaltOut, S};
    if (int e = launch_gemm(h, F, w2t, F, M, E, F, e2, st)) return e;
    if (int e = launch_ln_bwd<bf16, bf16, float, bf16, float>(gy, y32, ln_g, eps, M, E, nullptr,
                                                              y32, part, dln, st))
      return e;
    if (int e = launch_drop_cast_sum<float>(y32, dy0, M, E, outd, kSaltOut, S, part_b2, db2, st))
      return e;
  } else if (int e = launch_drop_cast_sum<bf16>(gy, dy0, M, E, outd, kSaltOut, S, part_b2, db2,
                                                  st)) {
    return e;
  }
  if (int e = ffn_bwd_wgmma_launch(a, dy0, w1t, b1, w2t, M, E, F, S, mid,
                                   ln_mode == 2 ? nullptr : h, dhp, part_b1, st))
    return e;
  if (int e = launch_fold_columns(part_b1, (M + 127) / 128, F, db1, st)) return e;
  // dxn = dh_pre . W1; W1^T [E, F] is the K-major operand
  if (ln_mode == 1) {
    const Epilogue ep{nullptr, nullptr, 0, dxn, E, ACT_NONE, 1};
    if (int e = launch_gemm(dhp, F, w1f, F, M, E, F, ep, st)) return e;
    return launch_ln_bwd<bf16, float, bf16, bf16, bf16>(dxn, x, ln_g, eps, M, E,
                                                        residual ? gy : nullptr, dx, part, dln, st);
  }
  // post-LN: dx = dxn + dysum (residual); none: dx = dxn + gy (residual)
  const void* res = !residual ? nullptr : ln_mode == 2 ? (const void*)y32 : gy;
  const Epilogue ep{nullptr, res, E, dx, E, ACT_NONE, 0, ln_mode == 2};
  return launch_gemm(dhp, F, w1f, F, M, E, F, ep, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. ln_mode: 0 none, 1 pre-LN, 2 post-LN. w1t
// [F, E], w2t [E, F] in torch Linear layout (the forward's operands); w1f
// [E, F], w2f [F, E] their transposes (the K-major operands of dxn and, on
// the gemm.cuh chain, of dh; the wgmma chain reads w2t and takes w2f null).
// Rows M = B*S. seed: device int32 [1] or null; each dropout is (thresh,
// scale, on). Outputs: xn [M, E] (pre-LN), h [M, F], dy0 [M, E], dhp [M, F],
// dx [M, E] and dsum f32: dln [2, E] (with LN) and, on the wgmma chain, db1
// [F] and db2 [E] after it. Scratch: hpre f32 [M, F] (gemm.cuh chain only,
// else null), y32 f32 [M, E] (post-LN), dxn f32 [M, E] (pre-LN), part f32
// (run_wgmma's layout; `ffn_bwd_part_floats` in ops/hopper/ffn_block.py).
// Returns the first CUDA error, or 0.
extern "C" int smm_ffn_block_bwd(int dtype, const void* x, const void* gy, const void* w1t,
                                 const void* b1, const void* w2t, const void* b2, const void* w1f,
                                 const void* w2f, const void* ln_g, const void* ln_b, float eps,
                                 int ln_mode, int residual, int M, int E, int F, int S,
                                 const int* seed, unsigned thresh_mid, float scale_mid,
                                 int on_mid, unsigned thresh_out, float scale_out, int on_out,
                                 void* xn, float* hpre, void* h, float* y32, void* dy0, void* dhp,
                                 float* dxn, void* dx, float* part, float* dsum, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop mid{on_mid ? seed : nullptr, thresh_mid, scale_mid};
  const Drop outd{on_out ? seed : nullptr, thresh_out, scale_out};
  if (ffn_bwd_wgmma_takes(dtype == 1, E, F))
    return run_wgmma((const bf16*)x, (const bf16*)gy, (const bf16*)w1t, (const bf16*)b1,
                     (const bf16*)w2t, (const bf16*)b2, (const bf16*)w1f, (const bf16*)ln_g,
                     (const bf16*)ln_b, eps, ln_mode, residual, M, E, F, S, mid, outd, (bf16*)xn,
                     (bf16*)h, y32, (bf16*)dy0, (bf16*)dhp, dxn, (bf16*)dx, part, dsum, st);
  if (dtype == 1)
    return run_chain<bf16>(x, gy, w1t, b1, w2t, b2, w1f, w2f, ln_g, ln_b, eps, ln_mode, residual,
                           M, E, F, S, mid, outd, xn, hpre, h, y32, dy0, dhp, dxn, dx, part, dsum,
                           st);
  return run_chain<float>(x, gy, w1t, b1, w2t, b2, w1f, w2f, ln_g, ln_b, eps, ln_mode, residual, M,
                          E, F, S, mid, outd, xn, hpre, h, y32, dy0, dhp, dxn, dx, part, dsum, st);
}

// The LayerNorm backward alone, as the pre-LN sites call it (bf16 rows
// beside an f32 cotangent): dy f32 [M, E], x, g and add (or null) bf16, dx
// bf16 [M, E], part f32 [row_blocks(M), 2E], dln f32 [2, E]. Returns the
// first CUDA error, or 0.
extern "C" int smm_ln_bwd(const float* dy, const void* x, const void* g, float eps, int M, int E,
                          const void* add, void* dx, float* part, float* dln, void* stream) {
  return launch_ln_bwd<bf16, float, bf16, bf16, bf16>(dy, (const bf16*)x, (const bf16*)g, eps, M,
                                                      E, (const bf16*)add, (bf16*)dx, part, dln,
                                                      (cudaStream_t)stream);
}
