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
// What bounds it here: per (query tile, key tile) four small tensor-core
// products in bf16 (QK^T, P.V, and the query/key rows against the <=127
// staged table rows, whose (q, k) diagonals are then read back from shared
// memory); f32 runs them as FMA loops. No [S, S] tensor and no
// [S, 2*span] table product reaches device memory.

#include "attention.cuh"

namespace {

using namespace smm;

template <typename T>
int run(const void* q, const void* k, const void* v, int ld, const void* pos_k,
        const void* pos_q, int ldp, const int* idx_c, const int* idx_p, const int* mask, int B,
        int S, int H, int D, Drop drop, void* out, cudaStream_t st) {
  AttnArgs at{};
  at.q = q;
  at.k = k;
  at.v = v;
  at.ldq = at.ldk = at.ldv = ld;
  at.out = out;
  at.ldo = ld;
  at.S = S;
  at.H = H;
  at.scale = 1.0f / sqrtf(3.0f * (float)D);
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
// mask int32 [B, S]; seed device int32 [1] or null (no dropout). Returns
// the first CUDA error, or 0.
extern "C" int smm_deberta_attention(int dtype, const void* q, const void* k, const void* v,
                                     int ld, const void* pos_k, const void* pos_q, int ldp,
                                     const int* idx_c, const int* idx_p, const int* mask, int B,
                                     int S, int H, int D, const int* seed, unsigned thresh,
                                     float scale, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop drop{seed, thresh, scale};
  if (dtype == 1)
    return run<bf16>(q, k, v, ld, pos_k, pos_q, ldp, idx_c, idx_p, mask, B, S, H, D, drop, out,
                     st);
  return run<float>(q, k, v, ld, pos_k, pos_q, ldp, idx_c, idx_p, mask, B, S, H, D, drop, out,
                    st);
}
