// Fused self-attention block for Hopper: [pre-LN ->] q, k, v = x W + b ->
// per head softmax(q k^T / sqrt(D)) [hash dropout] v -> out-projection +
// bias [+ x].
//
// Replaces simple_multimodal_tpu/ops/pallas/attention_block.py, `_kernel`
// via `_fused_call` (forward). The TPU kernel keeps one batch item's
// [S, E] tile in VMEM and separates heads with masked 128-lane matmuls; on
// the H100 the block is a chain of launches on one stream:
//   1. LayerNorm rows (f32 statistics) when `ln` is given;
//   2. three tiled GEMMs (bf16 on the tensor cores) with a bias epilogue,
//      writing q|k|v side by side into one packed [rows, 3E] buffer;
//   3. the streaming attention kernel (attention.cuh), one block per
//      (query tile, head, batch), reading q/k/v in [B, S, H, D] straight
//      from the packed buffer;
//   4. the out-projection GEMM with the bias and residual in its epilogue.
// What bounds it here: the four projections are tensor-core GEMMs at
// rows = B*S, compute-bound at the ViT stack's 47k rows and limited by the
// WMMA GEMM's rate (~150 TFLOP/s measured, see PERF.md); the attention core
// (bf16: WMMA for QK^T and P.V) is the smaller part. The q|k|v buffer and
// the context round-trip device memory once each; keeping them on chip, and
// wgmma/TMA, is later work.

#include "attention.cuh"
#include "gemm.cuh"

namespace {

using namespace smm;

template <typename T>
int run(const void* x, const void* wq, const void* bq, const void* wk, const void* bk,
        const void* wv, const void* bv, const void* wo, const void* bo, const void* ln_g,
        const void* ln_b, float ln_eps, int residual, int B, int S, int E, int H, Drop drop,
        void* xn, void* qkv, void* ctx, void* out, cudaStream_t st) {
  const int M = B * S, D = E / H;
  const T* a = (const T*)x;
  if (ln_g) {
    if (int e = launch_layernorm<T, T>((const T*)x, (const T*)ln_g, (const T*)ln_b, (T*)xn, M, E,
                                       ln_eps, st))
      return e;
    a = (const T*)xn;
  }
  const void* ws[3] = {wq, wk, wv};
  const void* bs[3] = {bq, bk, bv};
  for (int i = 0; i < 3; ++i) {
    Epilogue ep{bs[i], nullptr, 0, (T*)qkv + i * E, 3 * E, ACT_NONE, 0};
    if (int e = launch_gemm(a, E, (const T*)ws[i], E, M, E, E, ep, st)) return e;
  }
  AttnArgs at{};
  at.q = qkv;
  at.k = (const T*)qkv + E;
  at.v = (const T*)qkv + 2 * E;
  at.ldq = at.ldk = at.ldv = 3 * E;
  at.out = ctx;
  at.ldo = E;
  at.S = S;
  at.H = H;
  at.scale = 1.0f / sqrtf((float)D);
  at.drop = drop;
  if (int e = launch_attention<T, false>(at, B, D, st)) return e;
  Epilogue ep{bo, residual ? x : nullptr, E, out, E, ACT_NONE, 0};
  return launch_gemm((const T*)ctx, E, (const T*)wo, E, M, E, E, ep, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Weights in torch Linear layout [E_out, E_in].
// seed: device int32 [1], or null for no dropout; thresh = rate * 2^32,
// scale = 1 / (1 - rate). xn [B*S, E] (used when ln_g is set), qkv
// [B*S, 3E] and ctx [B*S, E] are scratch the caller allocates. Returns the
// first CUDA error, or 0.
extern "C" int smm_attention_block(int dtype, const void* x, const void* wq, const void* bq,
                                   const void* wk, const void* bk, const void* wv,
                                   const void* bv, const void* wo, const void* bo,
                                   const void* ln_g, const void* ln_b, float ln_eps,
                                   int residual, int B, int S, int E, int H, const int* seed,
                                   unsigned thresh, float scale, void* xn, void* qkv, void* ctx,
                                   void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop drop{seed, thresh, scale};
  if (dtype == 1)
    return run<bf16>(x, wq, bq, wk, bk, wv, bv, wo, bo, ln_g, ln_b, ln_eps, residual, B, S, E,
                     H, drop, xn, qkv, ctx, out, st);
  return run<float>(x, wq, bq, wk, bk, wv, bv, wo, bo, ln_g, ln_b, ln_eps, residual, B, S, E, H,
                    drop, xn, qkv, ctx, out, st);
}

extern "C" const char* smm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
