// Backward of DeBERTa's disentangled attention on wgmma, the dq kernel
// (bf16, head width 64): dq = ds (k + pos_k[idx_c(q - k)]) / sqrt(3D) and the
// per-offset sums of the pos_k cotangent, gc[r] = sum_{q - k = r} ds q_q.
//
// Part of the backward that replaces
// simple_multimodal_tpu/ops/pallas/deberta_attention.py, `_bwd_kernel` via
// `_bwd_call`; the arithmetic is attention_bwd.cuh's (p re-formed from the
// re-run forward's row maximum and sum, the hash dropout replayed, no
// gradient through a masked key, ds rounded to bf16 before it meets k, the
// table rows and q). How the relative-position terms are formed in the
// accumulator layout is in deberta_scores_wgmma.cuh.
//
// What bounds it on this card: operations (per 64 x 64 tile pair the
// products q.k^T, dout.v^T, ds.k of 64 x 64 x 64 and Q.PKg^T, K.PQg^T,
// ds_c.PKg, X.Q of 64 x 128 x 64: 6.3 MFLOP). What the design does about
// it: a block of one consumer warpgroup and four producer warps owns 64
// query rows (Q and dout resident in shared memory); per key tile the
// producers copy K and V by TMA and stage the two tables' rows for the
// pair's 127 offsets; every product is a wgmma, the scores and ds live in accumulator
// registers, ds goes back in as the A registers of ds.k and, skewed through
// shared memory, as the A operand of the table term and of the per-offset
// sums; dq stays in registers until the store.
//
// The per-offset sums: the pair (query tile i, key tile j) covers offsets
// 64 (i - j) - 63 + u, u < 128, so the lower half of pair j is the upper
// half of pair j + 1. A second accumulator carries the lower half into the
// next pair's product (scale-d = 1), is complete after it, and is written
// once as block j of this query tile's partial [T + 1][64 offsets][64]; the
// fold (deberta_attention_bwd.cu) adds the query tiles' partials, the batch
// and the offsets of a bucket in a fixed order. No atomics: two runs give
// the same bits.

#include "deberta_scores_wgmma.cuh"

namespace smm {
namespace debw {
namespace {

struct DqPlan {
  static constexpr int q = 0;
  static constexpr int g = q + kTileBytes;                     // dout
  static constexpr int k = g + kTileBytes;                     // [stage]
  static constexpr int v = k + kStagesRel * kTileBytes;
  static constexpr int pk = v + kStagesRel * kTileBytes;       // [stage] staged pos_k rows
  static constexpr int pq = pk + kStagesRel * kTableBytes;
  static constexpr int cq = pq + kStagesRel * kTableBytes;     // Q . PKg^T, f32
  static constexpr int ck = cq + kProductBytes;                // K . PQg^T, f32
  static constexpr int dsc = ck + kProductBytes;               // ds on (query, u)
  static constexpr int x = dsc + kSkewBytes;                   // ds on (u, query)
  static constexpr int flags = x + kSkewBytes;                 // [stage][64] key states
  static constexpr int bars = flags + kStagesRel * kTile * 4;  // own_full, full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStagesRel) + 1024;
};

// Key states the producer stages beside the tables.
constexpr int kPast = 0, kMasked = 1, kLive = 2;

template <bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    deberta_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mg,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv, RelBwdArgs a) {
  using P = DqPlan;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t Qs = hp::smem_u32(smem + P::q), Gs = hp::smem_u32(smem + P::g),
                 Ks = hp::smem_u32(smem + P::k), Vs = hp::smem_u32(smem + P::v),
                 PKs = hp::smem_u32(smem + P::pk), PQs = hp::smem_u32(smem + P::pq),
                 DSC = hp::smem_u32(smem + P::dsc), X = hp::smem_u32(smem + P::x),
                 bars = hp::smem_u32(smem + P::bars);
  float* Cq = reinterpret_cast<float*>(smem + P::cq);
  float* Ck = reinterpret_cast<float*>(smem + P::ck);
  int* Flags = reinterpret_cast<int*>(smem + P::flags);
  const uint32_t own_full = bars, full = bars + 8, empty = bars + 8 + 8 * kStagesRel;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, tiles = (S + kTile - 1) / kTile;
  const size_t bh = (size_t)b * a.H + h;

  if (threadIdx.x == 0) {
    hp::mbar_init(own_full, 1);
    for (int s = 0; s < kStagesRel; ++s) {
      hp::mbar_init(full + 8 * s, kProducerWarps);
      hp::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hp::mbar_fence_init();
  }
  zero_smem(smem + P::dsc, 2 * kSkewBytes);  // each element's place is fixed: zeroed once
  fence_async_smem();
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warps: tables by all, copies by the first
    const int p = warp - kConsumerWarps;
    if (p == 0 && lane == 0) {
      hp::mbar_arrive_expect_tx(own_full, 2 * kTileBytes);
      load_tile<kD, kTile>(Qs, &mq, own_full, h, q0, b);
      load_tile<kD, kTile>(Gs, &mg, own_full, h, q0, b);
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStagesRel, k0 = t * kTile;
      if (t >= kStagesRel) hp::mbar_wait(empty + 8 * s, (t / kStagesRel - 1) & 1);
      const int rel0 = q0 - k0 - (kTile - 1);
      stage_tables(smem + P::pk + s * kTableBytes, smem + P::pq + s * kTableBytes, a.pos_k,
                   a.pos_q, a.ldp, a.idx_c, a.idx_p, rel0, S, h, p, lane);
      if (p == 0)
        for (int r = lane; r < kTile; r += 32) {
          const int key = k0 + r;
          Flags[s * kTile + r] =
              key >= S ? kPast : (a.mask && a.mask[(size_t)b * S + key] == 0) ? kMasked : kLive;
        }
      fence_async_smem();
      __syncwarp();  // the arrival below publishes every lane's writes
      if (lane != 0) continue;
      if (p == 0) {
        hp::mbar_arrive_expect_tx(full + 8 * s, 2 * kTileBytes);
        load_tile<kD, kTile>(Ks + s * kTileBytes, &mk, full + 8 * s, h, k0, b);
        load_tile<kD, kTile>(Vs + s * kTileBytes, &mv, full + 8 * s, h, k0, b);
      } else {
        hp::mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  const Lane ln;
  const int row0 = q0 + ln.r, row1 = row0 + 8;  // this thread's two query rows
  // row statistics; a row past S, or one whose sum is 0, gets p = 0
  float m0 = 0.0f, m1 = 0.0f, il0 = 0.0f, il1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;
  if (row0 < S) {
    const float l = a.l[bh * S + row0];
    m0 = a.m[bh * S + row0];
    il0 = l > 0.0f ? 1.0f / l : 0.0f;
    dl0 = a.delta[bh * S + row0];
  }
  if (row1 < S) {
    const float l = a.l[bh * S + row1];
    m1 = a.m[bh * S + row1];
    il1 = l > 0.0f ? 1.0f / l : 0.0f;
    dl1 = a.delta[bh * S + row1];
  }
  const float scale = a.scale;
  uint32_t hash0 = 0, hash1 = 0;  // the row part of the dropout hash
  if constexpr (DROP) {
    const uint32_t seed = (uint32_t)*a.drop.seed;
    hash0 = hash_row(seed, (uint32_t)bh, row0);
    hash1 = hash_row(seed, (uint32_t)bh, row1);
  }
  float* part = a.gc_part + (bh * tiles + blockIdx.x) * (size_t)(tiles + 1) * kTile * kD;

  float dq[kD / 2], carry[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = carry[i] = 0.0f;

  hp::mbar_wait(own_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStagesRel, k0 = t * kTile;
    const uint32_t Kt = Ks + s * kTileBytes, Vt = Vs + s * kTileBytes,
                   PKt = PKs + s * kTableBytes, PQt = PQs + s * kTableBytes;
    const int* flags = Flags + s * kTile;
    hp::mbar_wait(full + 8 * s, (t / kStagesRel) & 1);
    {  // the two table products, through shared memory
      float tp[kU / 2];
      hp::wgmma_fence();
      mma_over_d<kD, kTile, kU>(tp, Qs, 0, PKt);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(tp);
      store_product(Cq, tp, ln);
      hp::wgmma_fence();
      mma_over_d<kD, kTile, kU>(tp, Kt, 0, PQt);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(tp);
      store_product(Ck, tp, ln);
    }
    float sc[kTile / 2], dp[kTile / 2];
    hp::wgmma_fence();
    mma_over_d<kD, kTile, kTile>(sc, Qs, 0, Kt);
    mma_over_d<kD, kTile, kTile>(dp, Gs, 0, Vt);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);
    consumer_sync();  // Cq and Ck are whole

    uint32_t dsr[kTile / 4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      float d0[2], d1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ki = 8 * j + ln.c + e, col = k0 + ki;
        const int u0 = ln.r - ki + (kTile - 1), u1 = u0 + 8;  // (q - k) - rel0 of the two rows
        const int state = flags[ki];
        const float x0 = sc[4 * j + e] + Cq[ln.r * kLdc + u0] + Ck[ki * kLdc + u0];
        const float x1 = sc[4 * j + 2 + e] + Cq[(ln.r + 8) * kLdc + u1] + Ck[ki * kLdc + u1];
        const float s0 = state == kMasked ? kMaskFill : x0 * scale;
        const float s1 = state == kMasked ? kMaskFill : x1 * scale;
        const float p0 = state != kPast && il0 > 0.0f ? __expf(s0 - m0) * il0 : 0.0f;
        const float p1 = state != kPast && il1 > 0.0f ? __expf(s1 - m1) * il1 : 0.0f;
        float g0 = dp[4 * j + e], g1 = dp[4 * j + 2 + e];
        if constexpr (DROP) {
          g0 = hash_row_keep(hash0, col, a.drop.thresh) ? g0 * a.drop.scale : 0.0f;
          g1 = hash_row_keep(hash1, col, a.drop.thresh) ? g1 * a.drop.scale : 0.0f;
        }
        d0[e] = state == kLive ? p0 * (g0 - dl0) * scale : 0.0f;
        d1[e] = state == kLive ? p1 * (g1 - dl1) * scale : 0.0f;
        store_bf16(smem + P::dsc, tile_offset<kTile>(ln.r, u0), d0[e]);
        store_bf16(smem + P::dsc, tile_offset<kTile>(ln.r + 8, u1), d1[e]);
        store_bf16(smem + P::x, tile_offset<kU>(u0, ln.r), d0[e]);
        store_bf16(smem + P::x, tile_offset<kU>(u1, ln.r + 8), d1[e]);
      }
      dsr[2 * j] = hp::pack_bf16(d0[0], d0[1]);
      dsr[2 * j + 1] = hp::pack_bf16(d1[0], d1[1]);
    }
    fence_async_smem();
    consumer_sync();  // the skewed ds tiles are whole

    hp::fence_regs(dq);
    hp::fence_regs(carry);
    hp::wgmma_fence();
    mma_over_rows<kD, kTile>(dq, dsr, Kt);                         // ds . k
    mma_smem_over_rows<kTile, kU, kU>(dq, DSC, 0, PKt, true);      // ds_c . pos_k rows
    mma_smem_over_rows<kU, kTile, kTile>(carry, X, kTile, Qs, true);  // upper offsets: complete
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dq);
    hp::fence_regs(carry);
    store_partial(part, t, carry, ln);
    hp::fence_regs(carry);
    hp::wgmma_fence();
    mma_smem_over_rows<kU, kTile, kTile>(carry, X, 0, Qs, false);  // lower offsets: carried on
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(carry);
    if (lane == 0) hp::mbar_arrive(empty + 8 * s);
  }
  store_partial(part, tiles, carry, ln);

  bf16* dQ = (bf16*)a.dq + (size_t)b * S * a.ld + h * kD + (size_t)q0 * a.ld;
  store_acc<kD>(dq, dQ, a.ld, S - q0, ln, 1.0f, 1.0f);
}

template <bool DROP>
int launch(const void* q, const void* k, const void* v, const void* dout, const RelBwdArgs& a,
           int B, cudaStream_t st) {
  static const int allowed = allow_smem(deberta_bwd_dq_wgmma_kernel<DROP>, DqPlan::bytes);
  if (allowed != 0) return allowed;
  const RowStrides rows{(long long)a.S * a.ld, a.ld};
  CUtensorMap mq, mg, mk, mv;
  if (int e = make_rows_map(&mq, q, rows, B, a.S, a.H, kD, kTile)) return e;
  if (int e = make_rows_map(&mg, dout, rows, B, a.S, a.H, kD, kTile)) return e;
  if (int e = make_rows_map(&mk, k, rows, B, a.S, a.H, kD, kTile)) return e;
  if (int e = make_rows_map(&mv, v, rows, B, a.S, a.H, kD, kTile)) return e;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, B);
  deberta_bwd_dq_wgmma_kernel<DROP><<<grid, kThreads, DqPlan::bytes, st>>>(mq, mg, mk, mv, a);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace

int deberta_bwd_dq_wgmma_launch(const void* q, const void* k, const void* v, const void* dout,
                                const RelBwdArgs& a, int B, cudaStream_t st) {
  return a.drop.seed ? launch<true>(q, k, v, dout, a, B, st)
                     : launch<false>(q, k, v, dout, a, B, st);
}

int deberta_bwd_dq_wgmma_smem() { return DqPlan::bytes; }

}  // namespace debw
}  // namespace smm
