// The dk/dv kernel of the wgmma flash-attention backward (bf16, head widths
// 64, 96, 128), as a template that two sources instantiate:
// flash_attention_bwd_dkv_wgmma.cu (flash_attention, with and without a
// bias; the design note is there) and attention_core_bwd_wgmma.cu (the
// backward core of attention_block with the replayed hash dropout).
#pragma once

#include "flash_attention_wgmma.cuh"

namespace smm {
namespace flashw {
namespace dkv {

constexpr int kKeyRows = 64;  // key rows per block: one warpgroup
constexpr int kQueries = 64;  // queries per streamed tile
constexpr int kConsumers = 4;
constexpr int kDkvThreads = kConsumers * 32 + 32;

template <int D>
struct DkvPlan {
  static constexpr int k = 0;
  static constexpr int v = k + tile_bytes<D, kKeyRows>();
  static constexpr int q = v + tile_bytes<D, kKeyRows>();
  static constexpr int g = q + kStages * tile_bytes<D, kQueries>();        // dout
  static constexpr int st = g + kStages * tile_bytes<D, kQueries>();       // [stage][3][64] f32
  static constexpr int bars = st + kStages * 3 * kQueries * 4;             // own_full, full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

// DROP: the replayed hash dropout of the probabilities (attention_block in
// training). Keys are the accumulator's rows here and queries its columns,
// so the hash's row part (which belongs to the query) is formed per column
// and the key enters as the row; compiled out of every other instantiation.
template <int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mg,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv, FlashBwdArgs a,
                               Drop drop) {
  using P = DkvPlan<D>;
  constexpr int QT = kQueries;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t Ks = hp::smem_u32(smem + P::k), Vs = hp::smem_u32(smem + P::v),
                 Qs = hp::smem_u32(smem + P::q), Gs = hp::smem_u32(smem + P::g),
                 bars = hp::smem_u32(smem + P::bars);
  float* St = reinterpret_cast<float*>(smem + P::st);
  const uint32_t own_full = bars, full = bars + 8, empty = bars + 8 + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kKeyRows, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.f.Sq, Sk = a.f.Sk;
  const int tiles = (Sq + QT - 1) / QT;
  const size_t bh = (size_t)b * a.f.H + h;

  if (threadIdx.x == 0) {
    hp::mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, kConsumers);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer warp: statistics by all lanes, copies by lane 0
    if (lane == 0) {
      hp::mbar_arrive_expect_tx(own_full, 2 * tile_bytes<D, kKeyRows>());
      load_tile<D, kKeyRows>(Ks, &mk, own_full, h, k0, b);
      load_tile<D, kKeyRows>(Vs, &mv, own_full, h, k0, b);
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) hp::mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
      float* stg = St + s * 3 * QT;
      for (int r = lane; r < QT; r += 32) {
        const int qi = t * QT + r;
        const bool ok = qi < Sq;
        const float l = ok ? a.l[bh * Sq + qi] : 0.0f;
        stg[r] = ok ? a.m[bh * Sq + qi] : 0.0f;
        stg[QT + r] = l > 0.0f ? 1.0f / l : 0.0f;
        stg[2 * QT + r] = ok ? a.delta[bh * Sq + qi] : 0.0f;
      }
      __syncwarp();  // the arrival below publishes every lane's writes
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(full + 8 * s, 2 * tile_bytes<D, QT>());
        load_tile<D, QT>(Qs + s * tile_bytes<D, QT>(), &mq, full + 8 * s, h, t * QT, b);
        load_tile<D, QT>(Gs + s * tile_bytes<D, QT>(), &mg, full + 8 * s, h, t * QT, b);
      }
    }
    return;
  }

  const Lane ln;
  const int key0 = k0 + ln.r, key1 = key0 + 8;  // this thread's two key rows
  const bool live0 = key0 < Sk, live1 = key1 < Sk;
  const float* bias0 = nullptr;
  const float* bias1 = nullptr;
  if constexpr (BIAS) {
    const float* base = a.f.bias + b * a.f.bb + h * a.f.bh;
    bias0 = base + min(key0, Sk - 1);  // the bias's key stride is 1
    bias1 = base + min(key1, Sk - 1);
  }
  const float scale = a.f.scale;
  uint32_t seed = 0;
  if constexpr (DROP) seed = (uint32_t)*drop.seed;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

  hp::mbar_wait(own_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages, q0 = t * QT;
    const uint32_t Qt = Qs + s * tile_bytes<D, QT>(), Gt = Gs + s * tile_bytes<D, QT>();
    const float* stg = St + s * 3 * QT;
    hp::mbar_wait(full + 8 * s, (t / kStages) & 1);
    float sc[QT / 2], dp[QT / 2];  // s^T and dp^T: rows = keys, columns = queries
    hp::wgmma_fence();
    mma_over_d<D, kKeyRows, QT>(sc, Ks, 0, Qt);
    mma_over_d<D, kKeyRows, QT>(dp, Vs, 0, Gt);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);

    uint32_t pt[QT / 4], dsr[QT / 4];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const int c = 8 * j + ln.c;  // this thread's two queries of the block: c, c + 1
      const float2 mq2 = *reinterpret_cast<const float2*>(stg + c);
      const float2 il2 = *reinterpret_cast<const float2*>(stg + QT + c);
      const float2 dl2 = *reinterpret_cast<const float2*>(stg + 2 * QT + c);
      const float mq_[2] = {mq2.x, mq2.y}, il_[2] = {il2.x, il2.y}, dl_[2] = {dl2.x, dl2.y};
      float p0[2], p1[2], d0[2], d1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * j + e] * scale, x1 = sc[4 * j + 2 + e] * scale;
        if constexpr (BIAS) {
          const long long qb = (long long)min(q0 + c + e, Sq - 1) * a.f.bq;
          x0 += bias0[qb];
          x1 += bias1[qb];
        }
        // a query past Sq (1/l = 0) must give exactly 0: it is a contraction index below
        const bool query = il_[e] > 0.0f;
        p0[e] = live0 && query ? __expf(x0 - mq_[e]) * il_[e] : 0.0f;
        p1[e] = live1 && query ? __expf(x1 - mq_[e]) * il_[e] : 0.0f;
        float g0 = dp[4 * j + e], g1 = dp[4 * j + 2 + e];
        if constexpr (DROP) {
          // kept: p and dp scaled by 1 / (1 - rate); dropped: both 0 (ds keeps -p delta)
          const uint32_t hq = hash_row(seed, (uint32_t)bh, (uint32_t)(q0 + c + e));
          const bool keep0 = hash_row_keep(hq, key0, drop.thresh);
          const bool keep1 = hash_row_keep(hq, key1, drop.thresh);
          g0 = keep0 ? g0 * drop.scale : 0.0f;
          g1 = keep1 ? g1 * drop.scale : 0.0f;
          d0[e] = p0[e] * (g0 - dl_[e]) * scale;
          d1[e] = p1[e] * (g1 - dl_[e]) * scale;
          p0[e] = keep0 ? p0[e] * drop.scale : 0.0f;  // what meets dout in dv
          p1[e] = keep1 ? p1[e] * drop.scale : 0.0f;
        } else {
          d0[e] = p0[e] * (g0 - dl_[e]) * scale;
          d1[e] = p1[e] * (g1 - dl_[e]) * scale;
        }
      }
      pt[2 * j] = hp::pack_bf16(p0[0], p0[1]);
      pt[2 * j + 1] = hp::pack_bf16(p1[0], p1[1]);
      dsr[2 * j] = hp::pack_bf16(d0[0], d0[1]);
      dsr[2 * j + 1] = hp::pack_bf16(d1[0], d1[1]);
    }

    hp::fence_regs(dv);
    hp::fence_regs(dk);
    hp::wgmma_fence();
    mma_over_rows<D, QT>(dv, pt, Gt);
    mma_over_rows<D, QT>(dk, dsr, Qt);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dv);
    hp::fence_regs(dk);
    if (lane == 0) hp::mbar_arrive(empty + 8 * s);
  }

  bf16* dK = head_rows<bf16>(a.dk, a.sdk, b, h, D) + (size_t)k0 * a.sdk.token;
  bf16* dV = head_rows<bf16>(a.dv, a.sddv, b, h, D) + (size_t)k0 * a.sddv.token;
  store_acc<D>(dk, dK, a.sdk.token, Sk - k0, ln, 1.0f, 1.0f);
  store_acc<D>(dv, dV, a.sddv.token, Sk - k0, ln, 1.0f, 1.0f);
}

// Builds the four tensor maps (per call, on the host) and launches.
template <int D, bool BIAS, bool DROP>
int launch_dkv(const FlashBwdArgs& a, const Drop& drop, int B, cudaStream_t st) {
  constexpr int bytes = DkvPlan<D>::bytes;
  static const int allowed = allow_smem(flash_bwd_dkv_wgmma_kernel<D, BIAS, DROP>, bytes);
  if (allowed != 0) return allowed;
  CUtensorMap mq, mg, mk, mv;
  const FlashArgs& f = a.f;
  if (int e = make_rows_map(&mq, f.q, f.sq, B, f.Sq, f.H, D, kQueries)) return e;
  if (int e = make_rows_map(&mg, a.dout, a.sdo, B, f.Sq, f.H, D, kQueries)) return e;
  if (int e = make_rows_map(&mk, f.k, f.sk, B, f.Sk, f.H, D, kKeyRows)) return e;
  if (int e = make_rows_map(&mv, f.v, f.sv, B, f.Sk, f.H, D, kKeyRows)) return e;
  const dim3 grid((f.Sk + kKeyRows - 1) / kKeyRows, f.H, B);
  flash_bwd_dkv_wgmma_kernel<D, BIAS, DROP>
      <<<grid, kDkvThreads, bytes, st>>>(mq, mg, mk, mv, a, drop);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace dkv
}  // namespace flashw
}  // namespace smm
