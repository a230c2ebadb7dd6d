// Backward of the fused self-attention block for Hopper.
//
// Replaces simple_multimodal_tpu/ops/pallas/attention_block.py, `_bwd_kernel`
// via `_block_bwd`. Like the TPU kernel it saves nothing from the forward
// but the inputs: it recomputes the pre-LN and the q/k/v projections, forms
// da = gy . Wo^T, re-runs the attention core for the context `a` and the
// softmax row statistics, runs the attention backward through the replayed
// dropout mask (attention_bwd.cuh) into one packed [rows, 3E] dq|dk|dv
// buffer, forms dxn = dq Wq^T + dk Wk^T + dv Wv^T as ONE GEMM over K = 3E
// against the concatenated flax-layout weights, and ends in the LayerNorm
// backward with the residual added (dx, and dgamma/dbeta summed per block
// and then over blocks in a fixed order). The four weight gradients are
// plain matmuls outside, as in the JAX `_block_bwd`.
//
// What bounds it on this card: operations (the five GEMMs, 3 projections +
// da + dxn = 16 rows E^2 FLOP, and the core's nine S S D products per
// head). What the design does about it, in bf16 at head widths 64 and 128
// (`attention_wgmma_takes`, attention.cuh): the GEMMs are the
// wgmma/TMA GEMM (gemm_wgmma.cu); the re-run of the forward core is the
// wgmma forward kernel itself (attention_core_wgmma.cu), asked for the row
// maximum and sum beside the context; delta = rowsum(da . ctx) per head is
// flash_attention's small row kernel; dq and dk/dv are the wgmma backward
// pair with the replayed dropout in the accumulator layout
// (attention_core_bwd_wgmma.cu), reading q | k | v and da in place and
// writing dq | dk | dv into the packed buffer the dxn GEMM reads. f32 and
// the other head widths keep attention.cuh's re-run and attention_bwd.cuh's
// kernels (WMMA in bf16, exact FMA loops in f32); the body is chosen from
// type and shape before anything is launched, and no error changes it. The
// TPU's VMEM budget gate (`_bwd_viable`, which sends wav2vec2's S = 499 to
// an XLA fallback) is a Mosaic limit: here the kernel serves every S.

#include "attention_bwd.cuh"
#include "flash_attention.cuh"
#include "gemm.cuh"

namespace {

using namespace smm;

template <typename T>
int run(const void* x, const void* gy, const void* wq, const void* bq, const void* wk,
        const void* bk, const void* wv, const void* bv, const void* wcat, const void* wo,
        const void* ln_g, const void* ln_b, float ln_eps, int residual, int B, int S, int E,
        int H, Drop drop, void* xn, void* qkv, void* da, void* a, float* stats, void* dqkv,
        float* dxn, void* dx, float* part, float* dln, cudaStream_t st) {
  const int M = B * S, D = E / H;
  const size_t BHS = (size_t)B * H * S;
  const T* in = (const T*)x;
  if (ln_g) {
    if (int e = launch_layernorm<T, T>((const T*)x, (const T*)ln_g, (const T*)ln_b, (T*)xn, M, E,
                                       ln_eps, st))
      return e;
    in = (const T*)xn;
  }
  const void* ws[3] = {wq, wk, wv};
  const void* bs[3] = {bq, bk, bv};
  if (int e = launch_gemm_qkv<T>(in, E, ws, bs, M, E, E, qkv, st)) return e;
  {  // da = gy . Wo^T: the flax [E_in, E_out] weight is the K-major operand
    Epilogue ep{nullptr, nullptr, 0, da, E, ACT_NONE, 0};
    if (int e = launch_gemm((const T*)gy, E, (const T*)wo, E, M, E, E, ep, st)) return e;
  }
  const float scale = 1.0f / sqrtf((float)D);
  float* m = stats;
  float* l = stats + BHS;
  float* delta = stats + 2 * BHS;
  if (attention_wgmma_takes(sizeof(T) == 2, D, false)) {
    // q, k, v and dq, dk, dv as [B, S, H, D] views of the packed buffers
    // (token stride 3E), the context and da with token stride E
    const RowStrides packed{(long long)S * 3 * E, 3 * E}, rows{(long long)S * E, E};
    const FlashArgs fa{qkv, (const T*)qkv + E, (const T*)qkv + 2 * E, packed, packed, packed,
                       nullptr, 0, 0, 0, 0, S, S, H, scale};
    const FlashOut fo{a, rows, m, l};
    if (int e = attention_core_wgmma_launch(fa, fo, drop, B, D, st)) return e;
    FlashBwdArgs bw{};
    bw.f = fa;
    bw.out = a;
    bw.dout = da;
    bw.so = bw.sdo = rows;
    bw.m = m;
    bw.l = l;
    bw.delta = delta;
    bw.dq = dqkv;
    bw.dk = (T*)dqkv + E;
    bw.dv = (T*)dqkv + 2 * E;
    bw.sdq = bw.sdk = bw.sddv = packed;
    flash_delta_kernel<T><<<(B * S * H + 3) / 4, 128, 0, st>>>(bw, B, D);
    SMM_CHECK_LAUNCH();
    if (int e = attention_core_bwd_wgmma_launch(bw, drop, B, D, st)) return e;
  } else {
    AttnArgs at{};
    at.q = qkv;
    at.k = (const T*)qkv + E;
    at.v = (const T*)qkv + 2 * E;
    at.ldq = at.ldk = at.ldv = 3 * E;
    at.out = a;
    at.ldo = E;
    at.S = S;
    at.H = H;
    at.scale = scale;
    at.drop = drop;
    at.m_out = m;
    at.l_out = l;
    at.delta = delta;
    at.dout = da;
    at.lddo = E;
    if (int e = launch_attention<T, false>(at, B, D, st)) return e;
    AttnBwdArgs bw{};
    bw.f = at;
    bw.dout = da;
    bw.m = m;
    bw.l = l;
    bw.delta = delta;
    bw.dq = dqkv;
    bw.dk = (T*)dqkv + E;
    bw.dv = (T*)dqkv + 2 * E;
    bw.lddq = bw.lddk = bw.lddv = 3 * E;
    if (int e = launch_attention_bwd<T, false>(bw, B, D, st)) return e;
  }
  // dxn = dqkv . [Wq | Wk | Wv]^T over K = 3E
  const T* res = residual ? (const T*)gy : nullptr;
  if (!ln_g) {
    Epilogue ep{nullptr, res, E, dx, E, ACT_NONE, 0};
    return launch_gemm((const T*)dqkv, 3 * E, (const T*)wcat, 3 * E, M, E, 3 * E, ep, st);
  }
  Epilogue ep{nullptr, nullptr, 0, dxn, E, ACT_NONE, 1};
  if (int e = launch_gemm((const T*)dqkv, 3 * E, (const T*)wcat, 3 * E, M, E, 3 * E, ep, st))
    return e;
  return launch_ln_bwd<T, float, T, T, T>(dxn, (const T*)x, (const T*)ln_g, ln_eps, M, E, res,
                                          (T*)dx, part, dln, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. wq/wk/wv in torch Linear layout [E_out, E_in]
// (to recompute q/k/v); wcat = [Wq | Wk | Wv] in flax layout [E, 3E] and
// wo in flax layout [E, E] (the K-major operands of dxn and da). seed:
// device int32 [1] or null (no dropout). Outputs: xn [B*S, E] (with LN),
// the context a [B*S, E], dqkv [B*S, 3E], dx [B*S, E] and, with LN,
// dln [2, E] f32 (dgamma, dbeta). Scratch: qkv [B*S, 3E], da [B*S, E],
// stats f32 [3, B*H*S], dxn f32 [B*S, E] and part f32 [blocks, 2E] (with
// LN). Returns the first CUDA error, or 0.
extern "C" int smm_attention_block_bwd(int dtype, const void* x, const void* gy, const void* wq,
                                       const void* bq, const void* wk, const void* bk,
                                       const void* wv, const void* bv, const void* wcat,
                                       const void* wo, const void* ln_g, const void* ln_b,
                                       float ln_eps, int residual, int B, int S, int E, int H,
                                       const int* seed, unsigned thresh, float scale, void* xn,
                                       void* qkv, void* da, void* a, float* stats, void* dqkv,
                                       float* dxn, void* dx, float* part, float* dln,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop drop{seed, thresh, scale};
  if (dtype == 1)
    return run<bf16>(x, gy, wq, bq, wk, bk, wv, bv, wcat, wo, ln_g, ln_b, ln_eps, residual, B, S,
                     E, H, drop, xn, qkv, da, a, stats, dqkv, dxn, dx, part, dln, st);
  return run<float>(x, gy, wq, bq, wk, bk, wv, bv, wcat, wo, ln_g, ln_b, ln_eps, residual, B, S,
                    E, H, drop, xn, qkv, da, a, stats, dqkv, dxn, dx, part, dln, st);
}

// The body an attention core of a call takes: 1 = the wgmma kernels, 0 =
// attention_bwd.cuh's backwards and attention.cuh's forward (dtype: 0 = f32,
// 1 = bf16; D the head width; rel: 1 for deberta_attention, whose forward
// and backward both follow it, 0 for attention_block's backward). The rule
// the chains apply, for checks.
extern "C" int smm_attention_wgmma_route(int dtype, int D, int rel) {
  return attention_wgmma_takes(dtype == 1, D, rel != 0) ? 1 : 0;
}
