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
//
// What bounds it on this card: operations. Both products are tensor-core
// bound at the main path's row counts (4k-47k rows, E = 768, F = 3072:
// 4 rows E F FLOP on ~2 rows E + 2 E F elements), and K is short (768 for
// GEMM1), so a tile's ring fill and epilogue weigh as much as its products.
// What the design does about it: in bf16 at these widths both GEMMs are the
// wgmma/TMA kernel of gemm_wgmma.cu (TMA ring, two consumer warpgroups, two
// resident blocks an SM so one block's epilogue overlaps the other's
// products), with everything between the products fused into the epilogues
// on the accumulator registers: bias + tanh GELU + the mid dropout in GEMM1,
// bias + the output dropout + the residual (f32 out before a post-LN) in
// GEMM2. Other widths (the tiny preset) and f32 run gemm.cuh's WMMA and FMA
// kernels; the choice is made by shape in launch_gemm.
//
// The [rows, F] intermediate still round-trips device memory (written by
// GEMM1, read by GEMM2: 2 x rows x F x 2 bytes, 0.17 ms of the ViT call at
// 3.35 TB/s against 0.45 ms of products). Keeping it on chip would take one
// kernel for both products: a 128-row tile of the intermediate is 128 x 3072
// x 2 = 768 KB, more than three SMs' shared memory, and streaming it in
// F-slices instead needs GEMM2's [128, 768] f32 sums resident, 384 KB or 384
// registers a thread over two warpgroups. Neither fits one block; a cluster
// of blocks that splits E and exchanges slices through distributed shared
// memory would, and is later work.
// The tensor maps of both GEMMs are encoded on the host in every call
// (chip_smoke.py prints the cost of one).

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
