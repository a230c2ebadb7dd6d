// Fused self-attention block for Hopper: [pre-LN ->] q, k, v = x W + b ->
// per head softmax(q k^T / sqrt(D)) [hash dropout] v -> out-projection +
// bias [+ x].
//
// Replaces simple_multimodal_tpu/ops/pallas/attention_block.py, `_kernel`
// via `_fused_call` (forward). The TPU kernel keeps one batch item's
// [S, E] tile in VMEM and separates heads with masked 128-lane matmuls; on
// the H100 the block is a chain of launches on one stream:
//   1. LayerNorm rows (f32 statistics) when `ln` is given;
//   2. the q|k|v projection with a bias epilogue into one packed
//      [rows, 3E] buffer;
//   3. the attention core, one block per (query tile, head, batch), reading
//      q/k/v in [B, S, H, D] straight from the packed buffer;
//   4. the out-projection GEMM with the bias and residual in its epilogue.
//
// What bounds it on this card: operations (8 rows E^2 FLOP of projections
// and 4 rows S E of core per call; the projections are ~80% at the ViT
// site). What the design does about it, in bf16 at the base widths:
// - step 2 is ONE launch of the wgmma/TMA GEMM (gemm_wgmma.cu) over N = 3E:
//   the three weights and biases are reached through three tensor maps and
//   pointers picked by the tile's column block, so nothing is concatenated
//   per call and the ~4 000-row sites launch 576 tiles instead of 3 x 192;
// - step 3 is flash_attention's wgmma forward (attention_core_wgmma.cu):
//   K/V tiles by TMA in place from the packed buffer (token stride 3E),
//   scores and probabilities in accumulator registers, the hash dropout of
//   the probabilities formed there, compiled out of serving's instantiation;
// - step 4 is the same GEMM with bias + residual on its accumulators.
// f32, other head widths (the tiny preset) and shapes the wgmma GEMM does not
// take run gemm.cuh's WMMA/FMA kernels and attention.cuh's core: chosen by
// type and shape before anything is launched. The backward re-runs the same
// core with the row statistics asked for (attention_block_bwd.cu); the
// dropout mask is a pure function of (seed, b, h, q, k), so the two agree.
// The q|k|v buffer and the context round-trip device memory once each.

#include "flash_attention.cuh"
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
  if (int e = launch_gemm_qkv<T>(a, E, ws, bs, M, E, E, qkv, st)) return e;
  const float scale = 1.0f / sqrtf((float)D);
  if (sizeof(T) == 2 && (D == 64 || D == 128) && ptr_aligned(qkv, 16)) {
    // q, k, v as [B, S, H, D] views of the packed buffer: token stride 3E
    const RowStrides rows{(long long)S * 3 * E, 3 * E};
    const FlashArgs fa{qkv, (const T*)qkv + E, (const T*)qkv + 2 * E, rows, rows, rows,
                       nullptr, 0, 0, 0, 0, S, S, H, scale};
    const FlashOut fo{ctx, {(long long)S * E, E}, nullptr, nullptr};
    if (int e = attention_core_wgmma_launch(fa, fo, drop, B, D, st)) return e;
    Epilogue ep{bo, residual ? x : nullptr, E, out, E, ACT_NONE, 0};
    return launch_gemm((const T*)ctx, E, (const T*)wo, E, M, E, E, ep, st);
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
  at.scale = scale;
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
