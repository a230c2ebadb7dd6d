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
// The softmax row statistics and delta = dout . ctx come first. What bounds
// it on this card: operations, per element four length-D dot products and
// the accumulations. In bf16 at head width 64 (`attention_wgmma_takes`,
// attention.cuh) the whole backward is on wgmma: the forward
// (deberta_attention_fwd_wgmma.cu), then flash_attention's delta kernel, and
// two kernels for the rest (deberta_attention_bwd_dq_wgmma.cu,
// deberta_attention_bwd_dkv_wgmma.cu; all three on deberta_scores_wgmma.cuh):
// the relative-position terms are formed in the accumulator layout from two
// table products per tile pair, and the diagonal sums come out of the same
// two kernels as per-tile partials (`fold_partials_kernel` adds the tiles,
// the batch and a bucket's offsets in a fixed order). On this route the
// forward is that same wgmma kernel, and whenever a backward can follow it
// keeps its output and row statistics: the backward takes them instead of
// re-running the forward, and what it takes is bit for bit what a re-run
// would give, the same kernel on the same inputs (q, k, v, tables, mask,
// seed). Other widths and f32 keep attention.cuh's forward, which the
// backward re-runs into ctx and stats, and attention_bwd.cuh's three kernels
// (WMMA tiles in shared memory in bf16, exact FMA loops in f32) and
// `fold_kernel`. The body is chosen from type and shape before anything is
// launched.

#include "attention_bwd.cuh"
#include "deberta_scores_wgmma.cuh"

namespace {

using namespace smm;

// The wgmma kernels' partials folded into table rows:
// out[t, h*64 + d] = sum_b sum_{r in bucket t} sum_{tile i} part[b, h, i][r][d],
// in that fixed order. A tile's partial is [T + 1] blocks of 64 offsets;
// offset r lies in block `blk`, row `rr` where, with the query tile as the
// owner (by_key = 0, the dq kernel), 64 blk - rr = 64 i + 1 - r and, with
// the key tile as the owner (by_key = 1, the dk/dv kernel),
// 64 blk + rr = r + 64 i + 63; tiles whose range misses r hold nothing.
__global__ void fold_partials_kernel(const float* __restrict__ part,
                                     const int* __restrict__ order,
                                     const int* __restrict__ off, int rows, int B, int H, int T,
                                     int S, int by_key, float* __restrict__ out) {
  constexpr int D = 64;
  const int HD = H * D;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * HD) return;
  const int t = i / HD, h = (i % HD) / D, d = i % D;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* pb = part + (size_t)(b * H + h) * T * (T + 1) * 64 * D + d;
    for (int e = off[t]; e < off[t + 1]; ++e) {
      const int r = order[e] - (S - 1);
      for (int tile = 0; tile < T; ++tile) {
        int blk, rr;
        if (by_key) {
          const int w = r + 64 * tile + 63;
          if (w < 0 || w >= 64 * (T + 1)) continue;
          blk = w >> 6;
          rr = w & 63;
        } else {
          const int w = 64 * tile + 1 - r;
          if (w < -63 || w > 64 * T) continue;
          blk = (w + 63) >> 6;
          rr = 64 * blk - w;
        }
        s += pb[((size_t)(tile * (T + 1) + blk) * 64 + rr) * D];
      }
    }
  }
  out[i] = s;
}

template <typename T>
int run(const void* q, const void* k, const void* v, int ld, const void* pos_k, const void* pos_q,
        int ldp, const int* idx_c, const int* idx_p, const int* mask, int B, int S, int H, int D,
        Drop drop, const void* gy, void* ctx, float* stats, float* delta, void* dq, void* dk,
        void* dv, float* g_rel, const int* ord_c, const int* off_c, const int* ord_p,
        const int* off_p, int rows, float* dpos_k, float* dpos_q, cudaStream_t st) {
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
  at.delta = delta;
  at.dout = gy;
  at.lddo = ld;
  const int n = rows * H * D;
  if (attention_wgmma_takes(sizeof(T) == 2, D, true)) {
    const int tiles = (S + 63) / 64;
    debw::RelBwdArgs ra{};
    ra.pos_k = (const bf16*)pos_k;
    ra.pos_q = (const bf16*)pos_q;
    ra.ldp = ldp;
    ra.idx_c = idx_c;
    ra.idx_p = idx_p;
    ra.mask = mask;
    ra.S = S;
    ra.H = H;
    ra.scale = at.scale;
    ra.drop = drop;
    ra.m = stats;
    ra.l = stats + BHS;
    ra.delta = delta;
    ra.dq = dq;
    ra.dk = dk;
    ra.dv = dv;
    ra.ld = ld;
    ra.gc_part = g_rel;
    ra.gp_part = g_rel + (size_t)B * H * tiles * (tiles + 1) * 64 * 64;
    // context, row maximum and sum are the forward's; delta = rowsum(dout . ctx) per head
    const RowStrides tokens{(long long)S * ld, ld};
    FlashBwdArgs fd{};
    fd.f.Sq = S;
    fd.f.H = H;
    fd.out = ctx;
    fd.dout = gy;
    fd.so = fd.sdo = tokens;
    fd.delta = delta;
    flash_delta_kernel<bf16><<<(B * S * H + 3) / 4, 128, 0, st>>>(fd, B, D);
    SMM_CHECK_LAUNCH();
    if (int e = debw::deberta_bwd_dq_wgmma_launch(q, k, v, gy, ra, B, st)) return e;
    if (int e = debw::deberta_bwd_dkv_wgmma_launch(q, k, v, gy, ra, B, st)) return e;
    fold_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(ra.gc_part, ord_c, off_c, rows, B, H,
                                                          tiles, S, 0, dpos_k);
    SMM_CHECK_LAUNCH();
    fold_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(ra.gp_part, ord_p, off_p, rows, B, H,
                                                          tiles, S, 1, dpos_q);
    SMM_CHECK_LAUNCH();
    return 0;
  }
  if (int e = launch_attention<T, true>(at, B, D, st)) return e;
  const int R = 2 * S - 1;
  AttnBwdArgs bw{};
  bw.f = at;
  bw.dout = gy;
  bw.m = stats;
  bw.l = stats + BHS;
  bw.delta = delta;
  bw.dq = dq;
  bw.dk = dk;
  bw.dv = dv;
  bw.lddq = bw.lddk = bw.lddv = ld;
  bw.gc = g_rel;
  bw.gp = g_rel + (size_t)B * H * R * D;
  if (int e = launch_attention_bwd<T, true>(bw, B, D, st)) return e;
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
// f32 [rows, H*D]. ctx [B, S, H, D] and stats f32 [2, B*H*S] (row maximum,
// row sum): where the forward is the wgmma kernel (smm_attention_wgmma_route),
// its output and statistics; else scratch the forward is re-run into.
// Scratch: delta f32 [B*H*S], g_rel
// f32 [2, B, H, 2S - 1, D] or, where the wgmma kernels run (bf16, D = 64:
// `smm_attention_wgmma_route`), [2, B, H, T, T + 1, 64, 64] with T = ceil(S / 64).
// Returns the first CUDA error, or 0.
extern "C" int smm_deberta_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                         int ld, const void* pos_k, const void* pos_q, int ldp,
                                         const int* idx_c, const int* idx_p, const int* mask,
                                         int B, int S, int H, int D, const int* seed,
                                         unsigned thresh, float scale, const void* gy, void* ctx,
                                         float* stats, float* delta, void* dq, void* dk, void* dv,
                                         float* g_rel, const int* ord_c, const int* off_c,
                                         const int* ord_p, const int* off_p, int rows,
                                         float* dpos_k, float* dpos_q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Drop drop{seed, thresh, scale};
  if (dtype == 1)
    return run<bf16>(q, k, v, ld, pos_k, pos_q, ldp, idx_c, idx_p, mask, B, S, H, D, drop, gy, ctx,
                     stats, delta, dq, dk, dv, g_rel, ord_c, off_c, ord_p, off_p, rows, dpos_k, dpos_q,
                     st);
  return run<float>(q, k, v, ld, pos_k, pos_q, ldp, idx_c, idx_p, mask, B, S, H, D, drop, gy, ctx,
                    stats, delta, dq, dk, dv, g_rel, ord_c, off_c, ord_p, off_p, rows, dpos_k, dpos_q,
                    st);
}

// Dynamic shared memory (bytes) of the wgmma backward kernels: which = 0 the
// dq kernel, 1 the dk/dv kernel, 2 the forward.
extern "C" int smm_deberta_bwd_wgmma_smem(int which) {
  return which == 0   ? debw::deberta_bwd_dq_wgmma_smem()
         : which == 1 ? debw::deberta_bwd_dkv_wgmma_smem()
         : which == 2 ? debw::deberta_fwd_wgmma_smem()
                      : 0;
}
