// DeBERTa disentangled attention for Hopper:
//   softmax((q k^T + c2p + p2c) / sqrt(3D), masked keys = -1e30) [drop] v
//   c2p[q, k] = q_q . pos_k[idx_c(q - k)],  p2c[q, k] = k_k . pos_q[idx_p(q - k)]
//
// Replaces simple_multimodal_tpu/ops/pallas/deberta_attention.py, `_kernel`
// via `_fused_call` (forward). Mosaic has no gathers, so the TPU kernel
// forms the bias terms as table-window matmuls followed by a roll-based
// Toeplitz skew. Gathers are cheap here: one block per (query tile, head,
// batch) stages, for each key tile, the <= 127 position-table rows its
// relative offsets select (idx_c / idx_p are the host-built bucket maps),
// and adds the two bias dot products per (q, k) straight from shared
// memory inside the streaming attention kernel (attention.cuh, REL).
// What bounds it here: operations, per (query tile, key tile) four small
// products (QK^T, P.V, and the query/key rows against the <=127 staged table
// rows). No [S, S] tensor and no [S, 2*span] table product reaches device
// memory. In bf16 at head width 64 (attention_wgmma_takes, the rule that
// picks the backward's body, attention.cuh) the forward is the wgmma kernel
// of deberta_attention_fwd_wgmma.cu, which in training also stores each
// row's maximum and sum for the backward, so the backward re-runs nothing.
// f32 and D = 16, 32 keep attention.cuh's kernel (WMMA tiles in shared
// memory in bf16, FMA loops in f32), whose backward re-runs it. The body is
// chosen from type and shape before anything is launched.

#include "deberta_scores_wgmma.cuh"

namespace {

using namespace smm;

template <typename T>
int run(const void* q, const void* k, const void* v, int ld, const void* pos_k,
        const void* pos_q, int ldp, const int* idx_c, const int* idx_p, const int* mask, int B,
        int S, int H, int D, Drop drop, void* out, float* stats, cudaStream_t st) {
  const float scale = 1.0f / sqrtf(3.0f * (float)D);
  if (attention_wgmma_takes(sizeof(T) == 2, D, true)) {
    const size_t BHS = (size_t)B * H * S;
    const debw::RelFwdArgs fa{(const bf16*)pos_k, (const bf16*)pos_q, ldp, idx_c, idx_p, mask, S,
                              H, scale, drop, out, ld, stats, stats ? stats + BHS : nullptr};
    return debw::deberta_fwd_wgmma_launch(q, k, v, fa, B, st);
  }
  AttnArgs at{};
  at.q = q;
  at.k = k;
  at.v = v;
  at.ldq = at.ldk = at.ldv = ld;
  at.out = out;
  at.ldo = ld;
  at.S = S;
  at.H = H;
  at.scale = scale;
  at.pos_k = pos_k;
  at.pos_q = pos_q;
  at.ldp = ldp;
  at.idx_c = idx_c;
  at.idx_p = idx_p;
  at.mask = mask;
  at.drop = drop;
  return launch_attention<T, true>(at, B, D, st);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. q/k/v/out [B, S, H, D] with `ld` elements per
// token; pos_k/pos_q [2*span, ldp]; idx_c/idx_p int32 [2S - 1];
// mask int32 [B, S]; seed device int32 [1] or null (no dropout). stats: f32
// [2, B*H*S] that receives each row's maximum and sum (the backward's
// saved statistics), or null; only the wgmma body (smm_attention_wgmma_route
// with rel = 1) stores them. Returns the first CUDA error, or 0.
extern "C" int smm_deberta_attention(int dtype, const void* q, const void* k, const void* v,
                                     int ld, const void* pos_k, const void* pos_q, int ldp,
                                     const int* idx_c, const int* idx_p, const int* mask, int B,
                                     int S, int H, int D, const int* seed, unsigned thresh,
                                     float scale, void* out, float* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop drop{seed, thresh, scale};
  if (dtype == 1)
    return run<bf16>(q, k, v, ld, pos_k, pos_q, ldp, idx_c, idx_p, mask, B, S, H, D, drop, out,
                     stats, st);
  return run<float>(q, k, v, ld, pos_k, pos_q, ldp, idx_c, idx_p, mask, B, S, H, D, drop, out,
                    stats, st);
}
