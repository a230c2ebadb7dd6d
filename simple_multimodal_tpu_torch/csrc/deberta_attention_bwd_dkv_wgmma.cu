// Backward of DeBERTa's disentangled attention on wgmma, the dk/dv kernel
// (bf16, head width 64): dv = p~^T dout, dk = ds^T (q + pos_q[idx_p(q - k)])
// / sqrt(3D) and the per-offset sums of the pos_q cotangent,
// gp[r] = sum_{q - k = r} ds k_k.
//
// Part of the backward that replaces
// simple_multimodal_tpu/ops/pallas/deberta_attention.py, `_bwd_kernel` via
// `_bwd_call`; the mirror image of deberta_attention_bwd_dq_wgmma.cu (its
// header has the design): the key rows are the M axis, so s^T = k.q^T and
// dp^T = v.dout^T come out with keys as accumulator rows and queries as
// columns, K and V are resident, Q and dout stream through the ring with
// the tile's row statistics beside them, and the tables are staged for the
// same 127 offsets of each pair. The dropped probabilities p~^T and ds^T go
// back in as the A registers of dv += p~^T.dout and dk += ds^T.q; ds^T
// skewed onto (key, u) is the A operand of dk's table term and, onto (u,
// key), of the per-offset sums.
//
// What bounds it on this card: operations (6.8 MFLOP per 64 x 64 tile
// pair). The per-offset sums slide the other way here: query tiles stream in
// increasing order, so the UPPER half of pair j is the lower half of pair
// j + 1; the carried accumulator is written once per streamed tile as block
// j of this key tile's partial [T + 1][64 offsets][64]. No atomics.

#include "deberta_scores_wgmma.cuh"

namespace smm {
namespace debw {
namespace {

struct DkvPlan {
  static constexpr int k = 0;
  static constexpr int v = k + kTileBytes;
  static constexpr int q = v + kTileBytes;                      // [stage]
  static constexpr int g = q + kStagesRel * kTileBytes;         // [stage] dout
  static constexpr int pk = g + kStagesRel * kTileBytes;        // [stage] staged pos_k rows
  static constexpr int pq = pk + kStagesRel * kTableBytes;
  static constexpr int cq = pq + kStagesRel * kTableBytes;      // Q . PKg^T, f32
  static constexpr int ck = cq + kProductBytes;                 // K . PQg^T, f32
  static constexpr int dsp = ck + kProductBytes;                // ds^T on (key, u)
  static constexpr int x = dsp + kSkewBytes;                    // ds^T on (u, key)
  static constexpr int st = x + kSkewBytes;                     // [stage][3][64] m, 1/l, delta
  static constexpr int bars = st + kStagesRel * 3 * kTile * 4;  // own_full, full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStagesRel) + 1024;
};

template <bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    deberta_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                 const __grid_constant__ CUtensorMap mg,
                                 const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv, RelBwdArgs a) {
  using P = DkvPlan;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t Ks = hp::smem_u32(smem + P::k), Vs = hp::smem_u32(smem + P::v),
                 Qs = hp::smem_u32(smem + P::q), Gs = hp::smem_u32(smem + P::g),
                 PKs = hp::smem_u32(smem + P::pk), PQs = hp::smem_u32(smem + P::pq),
                 DSP = hp::smem_u32(smem + P::dsp), X = hp::smem_u32(smem + P::x),
                 bars = hp::smem_u32(smem + P::bars);
  float* Cq = reinterpret_cast<float*>(smem + P::cq);
  float* Ck = reinterpret_cast<float*>(smem + P::ck);
  float* St = reinterpret_cast<float*>(smem + P::st);
  const uint32_t own_full = bars, full = bars + 8, empty = bars + 8 + 8 * kStagesRel;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
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
  zero_smem(smem + P::dsp, 2 * kSkewBytes);  // each element's place is fixed: zeroed once
  fence_async_smem();
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warps: tables by all, the rest by the first
    const int p = warp - kConsumerWarps;
    if (p == 0 && lane == 0) {
      hp::mbar_arrive_expect_tx(own_full, 2 * kTileBytes);
      load_tile<kD, kTile>(Ks, &mk, own_full, h, k0, b);
      load_tile<kD, kTile>(Vs, &mv, own_full, h, k0, b);
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStagesRel, q0 = t * kTile;
      if (t >= kStagesRel) hp::mbar_wait(empty + 8 * s, (t / kStagesRel - 1) & 1);
      const int rel0 = q0 - k0 - (kTile - 1);
      stage_tables(smem + P::pk + s * kTableBytes, smem + P::pq + s * kTableBytes, a.pos_k,
                   a.pos_q, a.ldp, a.idx_c, a.idx_p, rel0, S, h, p, lane);
      float* stg = St + s * 3 * kTile;
      for (int r = lane; p == 0 && r < kTile; r += 32) {
        const int qi = q0 + r;
        const bool ok = qi < S;
        const float l = ok ? a.l[bh * S + qi] : 0.0f;
        stg[r] = ok ? a.m[bh * S + qi] : 0.0f;
        stg[kTile + r] = l > 0.0f ? 1.0f / l : 0.0f;  // 0: a query past S gives p = ds = 0
        stg[2 * kTile + r] = ok ? a.delta[bh * S + qi] : 0.0f;
      }
      fence_async_smem();
      __syncwarp();  // the arrival below publishes every lane's writes
      if (lane != 0) continue;
      if (p == 0) {
        hp::mbar_arrive_expect_tx(full + 8 * s, 2 * kTileBytes);
        load_tile<kD, kTile>(Qs + s * kTileBytes, &mq, full + 8 * s, h, q0, b);
        load_tile<kD, kTile>(Gs + s * kTileBytes, &mg, full + 8 * s, h, q0, b);
      } else {
        hp::mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  const Lane ln;
  const int key0 = k0 + ln.r, key1 = key0 + 8;  // this thread's two key rows
  // past the end: p = 0; masked: p from the finite fill, no gradient through the score
  const bool there0 = key0 < S, there1 = key1 < S;
  const bool live0 = there0 && !(a.mask && a.mask[(size_t)b * S + key0] == 0);
  const bool live1 = there1 && !(a.mask && a.mask[(size_t)b * S + key1] == 0);
  const float scale = a.scale;
  uint32_t seed = 0;
  if constexpr (DROP) seed = (uint32_t)*a.drop.seed;
  float* part = a.gp_part + (bh * tiles + blockIdx.x) * (size_t)(tiles + 1) * kTile * kD;

  float dk[kD / 2], dv[kD / 2], carry[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = carry[i] = 0.0f;

  hp::mbar_wait(own_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStagesRel, q0 = t * kTile;
    const uint32_t Qt = Qs + s * kTileBytes, Gt = Gs + s * kTileBytes,
                   PKt = PKs + s * kTableBytes, PQt = PQs + s * kTableBytes;
    const float* stg = St + s * 3 * kTile;
    hp::mbar_wait(full + 8 * s, (t / kStagesRel) & 1);
    {  // the two table products, through shared memory
      float tp[kU / 2];
      hp::wgmma_fence();
      mma_over_d<kD, kTile, kU>(tp, Ks, 0, PQt);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(tp);
      store_product(Ck, tp, ln);
      hp::wgmma_fence();
      mma_over_d<kD, kTile, kU>(tp, Qt, 0, PKt);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(tp);
      store_product(Cq, tp, ln);
    }
    float sc[kTile / 2], dp[kTile / 2];  // s^T and dp^T: rows = keys, columns = queries
    hp::wgmma_fence();
    mma_over_d<kD, kTile, kTile>(sc, Ks, 0, Qt);
    mma_over_d<kD, kTile, kTile>(dp, Vs, 0, Gt);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);
    consumer_sync();  // Cq and Ck are whole

    uint32_t pt[kTile / 4], dsr[kTile / 4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int c = 8 * j + ln.c;  // this thread's two queries of the tile: c, c + 1
      const float2 mq2 = *reinterpret_cast<const float2*>(stg + c);
      const float2 il2 = *reinterpret_cast<const float2*>(stg + kTile + c);
      const float2 dl2 = *reinterpret_cast<const float2*>(stg + 2 * kTile + c);
      const float mq_[2] = {mq2.x, mq2.y}, il_[2] = {il2.x, il2.y}, dl_[2] = {dl2.x, dl2.y};
      float p0[2], p1[2], d0[2], d1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = c + e;
        const int u0 = qi - ln.r + (kTile - 1), u1 = u0 - 8;  // (q - k) - rel0 of the two rows
        const float x0 = sc[4 * j + e] + Cq[qi * kLdc + u0] + Ck[ln.r * kLdc + u0];
        const float x1 = sc[4 * j + 2 + e] + Cq[qi * kLdc + u1] + Ck[(ln.r + 8) * kLdc + u1];
        const float s0 = live0 ? x0 * scale : kMaskFill;
        const float s1 = live1 ? x1 * scale : kMaskFill;
        const bool query = il_[e] > 0.0f;
        p0[e] = there0 && query ? __expf(s0 - mq_[e]) * il_[e] : 0.0f;
        p1[e] = there1 && query ? __expf(s1 - mq_[e]) * il_[e] : 0.0f;
        float g0 = dp[4 * j + e], g1 = dp[4 * j + 2 + e];
        if constexpr (DROP) {
          const uint32_t hq = hash_row(seed, (uint32_t)bh, (uint32_t)(q0 + qi));
          const bool keep0 = hash_row_keep(hq, key0, a.drop.thresh);
          const bool keep1 = hash_row_keep(hq, key1, a.drop.thresh);
          g0 = keep0 ? g0 * a.drop.scale : 0.0f;
          g1 = keep1 ? g1 * a.drop.scale : 0.0f;
          d0[e] = live0 ? p0[e] * (g0 - dl_[e]) * scale : 0.0f;
          d1[e] = live1 ? p1[e] * (g1 - dl_[e]) * scale : 0.0f;
          p0[e] = keep0 ? p0[e] * a.drop.scale : 0.0f;  // what meets dout in dv
          p1[e] = keep1 ? p1[e] * a.drop.scale : 0.0f;
        } else {
          d0[e] = live0 ? p0[e] * (g0 - dl_[e]) * scale : 0.0f;
          d1[e] = live1 ? p1[e] * (g1 - dl_[e]) * scale : 0.0f;
        }
        store_bf16(smem + P::dsp, tile_offset<kTile>(ln.r, u0), d0[e]);
        store_bf16(smem + P::dsp, tile_offset<kTile>(ln.r + 8, u1), d1[e]);
        store_bf16(smem + P::x, tile_offset<kU>(u0, ln.r), d0[e]);
        store_bf16(smem + P::x, tile_offset<kU>(u1, ln.r + 8), d1[e]);
      }
      pt[2 * j] = hp::pack_bf16(p0[0], p0[1]);
      pt[2 * j + 1] = hp::pack_bf16(p1[0], p1[1]);
      dsr[2 * j] = hp::pack_bf16(d0[0], d0[1]);
      dsr[2 * j + 1] = hp::pack_bf16(d1[0], d1[1]);
    }
    fence_async_smem();
    consumer_sync();  // the skewed ds^T tiles are whole

    hp::fence_regs(dv);
    hp::fence_regs(dk);
    hp::fence_regs(carry);
    hp::wgmma_fence();
    mma_over_rows<kD, kTile>(dv, pt, Gt);                          // p~^T . dout
    mma_over_rows<kD, kTile>(dk, dsr, Qt);                         // ds^T . q
    mma_smem_over_rows<kTile, kU, kU>(dk, DSP, 0, PQt, true);      // ds_p . pos_q rows
    mma_smem_over_rows<kU, kTile, kTile>(carry, X, 0, Ks, true);   // lower offsets: complete
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dv);
    hp::fence_regs(dk);
    hp::fence_regs(carry);
    store_partial(part, t, carry, ln);
    hp::fence_regs(carry);
    hp::wgmma_fence();
    mma_smem_over_rows<kU, kTile, kTile>(carry, X, kTile, Ks, false);  // upper: carried on
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(carry);
    if (lane == 0) hp::mbar_arrive(empty + 8 * s);
  }
  store_partial(part, tiles, carry, ln);

  const size_t base = (size_t)b * S * a.ld + h * kD + (size_t)k0 * a.ld;
  store_acc<kD>(dk, (bf16*)a.dk + base, a.ld, S - k0, ln, 1.0f, 1.0f);
  store_acc<kD>(dv, (bf16*)a.dv + base, a.ld, S - k0, ln, 1.0f, 1.0f);
}

template <bool DROP>
int launch(const void* q, const void* k, const void* v, const void* dout, const RelBwdArgs& a,
           int B, cudaStream_t st) {
  static const int allowed = allow_smem(deberta_bwd_dkv_wgmma_kernel<DROP>, DkvPlan::bytes);
  if (allowed != 0) return allowed;
  const RowStrides rows{(long long)a.S * a.ld, a.ld};
  CUtensorMap mq, mg, mk, mv;
  if (int e = make_rows_map(&mq, q, rows, B, a.S, a.H, kD, kTile)) return e;
  if (int e = make_rows_map(&mg, dout, rows, B, a.S, a.H, kD, kTile)) return e;
  if (int e = make_rows_map(&mk, k, rows, B, a.S, a.H, kD, kTile)) return e;
  if (int e = make_rows_map(&mv, v, rows, B, a.S, a.H, kD, kTile)) return e;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, B);
  deberta_bwd_dkv_wgmma_kernel<DROP><<<grid, kThreads, DkvPlan::bytes, st>>>(mq, mg, mk, mv, a);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace

int deberta_bwd_dkv_wgmma_launch(const void* q, const void* k, const void* v, const void* dout,
                                 const RelBwdArgs& a, int B, cudaStream_t st) {
  return a.drop.seed ? launch<true>(q, k, v, dout, a, B, st)
                     : launch<false>(q, k, v, dout, a, B, st);
}

int deberta_bwd_dkv_wgmma_smem() { return DkvPlan::bytes; }

}  // namespace debw
}  // namespace smm
