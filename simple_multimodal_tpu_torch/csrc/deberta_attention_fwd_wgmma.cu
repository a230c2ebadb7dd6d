// DeBERTa's disentangled attention forward on wgmma (bf16, head width 64):
// ctx = softmax((q k^T + c2p + p2c) / sqrt(3D), masked keys = -1e30)
// [hash dropout] v and, where asked for, each row's maximum and sum.
//
// Replaces simple_multimodal_tpu/ops/pallas/deberta_attention.py, `_kernel`
// via `_fused_call` (forward), where attention_wgmma_takes (attention.cuh)
// says so: deberta_attention.cu launches it, with the row statistics stored
// where a backward can follow (the backward takes them and the output as
// they are) and not in eval (null m and l). The conventions are attention.cuh's WMMA kernel's, which keeps f32 and the other
// widths: a finite -1e30 for masked keys (kept f32), so a row whose every key
// is masked attends uniformly; keys past S get weight 0; probabilities
// normalised by the sum of ALL exponentials, dropped and scaled before their
// bf16 rounding.
//
// What bounds it on this card: operations (per 64 x 64 tile pair q.k^T and
// p.v of 64 x 64 x 64 and the two table products of 64 x 128 x 64: 3.1
// MFLOP). The design is deberta_scores_wgmma.cuh's: one consumer warpgroup
// owns 64 query rows, four producer warps copy K and V by TMA and stage the
// tables' rows for the pair's 127 offsets, the table products go through
// shared memory and are added to the q.k^T accumulator by (row, column); the
// online softmax runs on the accumulator registers and P goes back in as the
// A registers of O += p.v (flash_attention_fwd_wgmma.cuh's scheme).

#include "deberta_scores_wgmma.cuh"

namespace smm {
namespace debw {
namespace {

struct FwdPlan {
  static constexpr int q = 0;
  static constexpr int k = q + kTileBytes;                     // [stage]
  static constexpr int v = k + kStagesRel * kTileBytes;
  static constexpr int pk = v + kStagesRel * kTileBytes;       // [stage] staged pos_k rows
  static constexpr int pq = pk + kStagesRel * kTableBytes;
  static constexpr int cq = pq + kStagesRel * kTableBytes;     // Q . PKg^T, f32
  static constexpr int ck = cq + kProductBytes;                // K . PQg^T, f32
  static constexpr int flags = ck + kProductBytes;             // [stage][64] key states
  static constexpr int bars = flags + kStagesRel * kTile * 4;  // own_full, full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStagesRel) + 1024;
};

constexpr int kPast = 0, kMasked = 1, kLive = 2;  // key states

template <bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
    deberta_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv, RelFwdArgs a) {
  using P = FwdPlan;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t Qs = hp::smem_u32(smem + P::q), Ks = hp::smem_u32(smem + P::k),
                 Vs = hp::smem_u32(smem + P::v), PKs = hp::smem_u32(smem + P::pk),
                 PQs = hp::smem_u32(smem + P::pq), bars = hp::smem_u32(smem + P::bars);
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
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warps: tables by all, copies by the first
    const int p = warp - kConsumerWarps;
    if (p == 0 && lane == 0) {
      hp::mbar_arrive_expect_tx(own_full, kTileBytes);
      load_tile<kD, kTile>(Qs, &mq, own_full, h, q0, b);
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
  const float scale = a.scale;
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
  float m0 = kMaskFill, m1 = kMaskFill, l0 = 0.0f, l1 = 0.0f;  // l: this lane's share
  uint32_t hash0 = 0, hash1 = 0;  // the row part of the dropout hash
  if constexpr (DROP) {
    const uint32_t seed = (uint32_t)*a.drop.seed;
    hash0 = hash_row(seed, (uint32_t)bh, row0);
    hash1 = hash_row(seed, (uint32_t)bh, row1);
  }

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
    float sc[kTile / 2];
    hp::wgmma_fence();
    mma_over_d<kD, kTile, kTile>(sc, Qs, 0, Kt);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    consumer_sync();  // Cq and Ck are whole

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ki = 8 * j + ln.c + e;
        const int u0 = ln.r - ki + (kTile - 1), u1 = u0 + 8;  // (q - k) - rel0 of the two rows
        const int state = flags[ki];
        float x0 = (sc[4 * j + e] + Cq[ln.r * kLdc + u0] + Ck[ki * kLdc + u0]) * scale;
        float x1 = (sc[4 * j + 2 + e] + Cq[(ln.r + 8) * kLdc + u1] + Ck[ki * kLdc + u1]) * scale;
        if (state != kLive) x0 = x1 = state == kMasked ? kMaskFill : -INFINITY;
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    consumer_sync();  // every thread has read Cq and Ck: the next pair may overwrite them
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = __expf(m0 - mx0), alpha1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
    uint32_t p[kTile / 4];
#pragma unroll
    for (int n = 0; n < kTile / 4; ++n) {  // column pairs: even n row 0, odd n row 1
      const float mx = (n & 1) ? mx1 : mx0;
      float pa = __expf(sc[2 * n] - mx), pb = __expf(sc[2 * n + 1] - mx);
      if (n & 1) sum1 += pa + pb; else sum0 += pa + pb;
      if constexpr (DROP) {
        const uint32_t hr = (n & 1) ? hash1 : hash0;
        const uint32_t col = k0 + 8 * (n >> 1) + ln.c;
        pa = hash_row_keep(hr, col, a.drop.thresh) ? pa * a.drop.scale : 0.0f;
        pb = hash_row_keep(hr, col + 1, a.drop.thresh) ? pb * a.drop.scale : 0.0f;
      }
      p[n] = hp::pack_bf16(pa, pb);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    hp::fence_regs(o);
    hp::wgmma_fence();
    mma_over_rows<kD, kTile>(o, p, Vt);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    if (lane == 0) hp::mbar_arrive(empty + 8 * s);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  bf16* O = (bf16*)a.out + (size_t)b * S * a.ld + h * kD + (size_t)q0 * a.ld;
  store_acc<kD>(o, O, a.ld, S - q0, ln, l0 > 0.0f ? 1.0f / l0 : 0.0f,
                l1 > 0.0f ? 1.0f / l1 : 0.0f);
  if (a.m && (lane & 3) == 0) {  // the statistics, where the caller keeps them
    if (row0 < S) {
      a.m[bh * S + row0] = m0;
      a.l[bh * S + row0] = l0;
    }
    if (row1 < S) {
      a.m[bh * S + row1] = m1;
      a.l[bh * S + row1] = l1;
    }
  }
}

template <bool DROP>
int launch(const void* q, const void* k, const void* v, const RelFwdArgs& a, int B,
           cudaStream_t st) {
  static const int allowed = allow_smem(deberta_fwd_wgmma_kernel<DROP>, FwdPlan::bytes);
  if (allowed != 0) return allowed;
  const RowStrides rows{(long long)a.S * a.ld, a.ld};
  CUtensorMap mq, mk, mv;
  if (int e = make_rows_map(&mq, q, rows, B, a.S, a.H, kD, kTile)) return e;
  if (int e = make_rows_map(&mk, k, rows, B, a.S, a.H, kD, kTile)) return e;
  if (int e = make_rows_map(&mv, v, rows, B, a.S, a.H, kD, kTile)) return e;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, B);
  deberta_fwd_wgmma_kernel<DROP><<<grid, kThreads, FwdPlan::bytes, st>>>(mq, mk, mv, a);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace

int deberta_fwd_wgmma_launch(const void* q, const void* k, const void* v, const RelFwdArgs& a,
                             int B, cudaStream_t st) {
  return a.drop.seed ? launch<true>(q, k, v, a, B, st) : launch<false>(q, k, v, a, B, st);
}

int deberta_fwd_wgmma_smem() { return FwdPlan::bytes; }

}  // namespace debw
}  // namespace smm
