// Backward of DeBERTa's disentangled attention for Hopper.
//
// Replaces simple_multimodal_tpu/ops/pallas/deberta_attention.py,
// `_bwd_kernel` via `_bwd_call`. It returns dq, dk, dv and the cotangents
// of both position tables ([2*span, H*D]), with the 1/sqrt(3D) scale on ds
// and the key mask (no gradient through a masked score):
//   dq_q += sum_k ds pos_k[idx_c(q - k)],   dk_k += sum_q ds pos_q[idx_p(q - k)],
//   dpos_k[idx_c(r)] += sum_{q-k=r} ds q_q, dpos_q[idx_p(r)] += sum_{q-k=r} ds k_k.
// The TPU kernel gets the table terms by un-skewing the score cotangent
// with rolls (`_unskew_cols`), a Mosaic device that is not carried over.
//
// The bucket map sends many offsets r to one table row, so the table
// gradient is a scatter-add. Scattering with f32 atomicAdd would give a sum
// whose order, and so whose value, changes from run to run. Instead the
// attention backward (attention_bwd.cuh, REL) first sums each diagonal
// q - k = r into one [2S - 1, D] row per (batch, head) (gc, gp, each row
// summed by one block), and fold_kernel then adds those rows into table
// rows through the host-built CSR of rel_index_maps (ops/hopper/
// deberta_attention.py `fold_order`), over the batch and the offsets of a
// bucket in a fixed order: deterministic, at the price of one extra pass
// over the S x S elements.
//
// The forward kernel is re-run first for the softmax row statistics and
// delta = dout . ctx. What bounds it here: per element four length-D dot
// products, recomputed in three kernels (dq; dk and dv; the diagonal sums);
// in bf16 on the tensor cores (WMMA tiles in shared memory, ~210 KB per
// block, so one block per SM), in f32 as exact FMA loops.

#include "attention_bwd.cuh"

namespace {

using namespace smm;

template <typename T>
int run(const void* q, const void* k, const void* v, int ld, const void* pos_k, const void* pos_q,
        int ldp, const int* idx_c, const int* idx_p, const int* mask, int B, int S, int H, int D,
        Drop drop, const void* gy, void* ctx, float* stats, void* dq, void* dk, void* dv,
        float* g_rel, const int* ord_c, const int* off_c, const int* ord_p, const int* off_p,
        int rows, float* dpos_k, float* dpos_q, cudaStream_t st) {
  const size_t BHS = (size_t)B * H * S;
  AttnArgs at{};
  at.q = q;
  at.k = k;
  at.v = v;
  at.ldq = at.ldk = at.ldv = ld;
  at.out = ctx;
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
  at.m_out = stats;
  at.l_out = stats + BHS;
  at.delta = stats + 2 * BHS;
  at.dout = gy;
  at.lddo = ld;
  if (int e = launch_attention<T, true>(at, B, D, st)) return e;
  const int R = 2 * S - 1;
  AttnBwdArgs bw{};
  bw.f = at;
  bw.dout = gy;
  bw.m = stats;
  bw.l = stats + BHS;
  bw.delta = stats + 2 * BHS;
  bw.dq = dq;
  bw.dk = dk;
  bw.dv = dv;
  bw.lddq = bw.lddk = bw.lddv = ld;
  bw.gc = g_rel;
  bw.gp = g_rel + (size_t)B * H * R * D;
  if (int e = launch_attention_bwd<T, true>(bw, B, D, st)) return e;
  const int n = rows * H * D;
  fold_kernel<<<(n + 255) / 256, 256, 0, st>>>(bw.gc, ord_c, off_c, rows, B, H, R, D, dpos_k);
  SMM_CHECK_LAUNCH();
  fold_kernel<<<(n + 255) / 256, 256, 0, st>>>(bw.gp, ord_p, off_p, rows, B, H, R, D, dpos_q);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. q/k/v/gy and the outputs dq/dk/dv [B, S, H, D]
// with `ld` elements per token; pos_k/pos_q [rows = 2*span, ldp];
// idx_c/idx_p int32 [2S - 1]; mask int32 [B, S]; seed device int32 [1] or
// null. ord_*/off_* are the fold CSRs of idx_c/idx_p. Outputs dpos_k/dpos_q
// f32 [rows, H*D]. Scratch: ctx [B, S, H, D], stats f32 [3, B*H*S], g_rel
// f32 [2, B, H, 2S - 1, D]. Returns the first CUDA error, or 0.
extern "C" int smm_deberta_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                         int ld, const void* pos_k, const void* pos_q, int ldp,
                                         const int* idx_c, const int* idx_p, const int* mask,
                                         int B, int S, int H, int D, const int* seed,
                                         unsigned thresh, float scale, const void* gy, void* ctx,
                                         float* stats, void* dq, void* dk, void* dv,
                                         float* g_rel, const int* ord_c, const int* off_c,
                                         const int* ord_p, const int* off_p, int rows,
                                         float* dpos_k, float* dpos_q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop drop{seed, thresh, scale};
  if (dtype == 1)
    return run<bf16>(q, k, v, ld, pos_k, pos_q, ldp, idx_c, idx_p, mask, B, S, H, D, drop, gy, ctx,
                     stats, dq, dk, dv, g_rel, ord_c, off_c, ord_p, off_p, rows, dpos_k, dpos_q,
                     st);
  return run<float>(q, k, v, ld, pos_k, pos_q, ldp, idx_c, idx_p, mask, B, S, H, D, drop, gy, ctx,
                    stats, dq, dk, dv, g_rel, ord_c, off_c, ord_p, off_p, rows, dpos_k, dpos_q,
                    st);
}
