// The dq kernel of the wgmma flash-attention backward (bf16, head widths 64,
// 96, 128), as a template that two sources instantiate:
// flash_attention_bwd_dq_wgmma.cu (flash_attention, with and without a bias;
// the design note is there) and attention_core_bwd_wgmma.cu (the backward
// core of attention_block with the replayed hash dropout).
#pragma once

#include "flash_attention_wgmma.cuh"

namespace smm {
namespace flashw {
namespace dq {

constexpr int kQRows = 128;                  // query rows per block: two warpgroups
constexpr int kKeys = 64;                    // keys per streamed tile
constexpr int kConsumers = kQRows / 64 * 4;  // consumer warps
// two consumer warpgroups and a producer warpgroup (one warp of it works):
// a block of 9 warps is given registers as one of 12, 168 a thread, so the
// producer is a whole warpgroup that hands its registers to the consumers
constexpr int kDqThreads = kConsumers * 32 + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int D>
struct DqPlan {
  static constexpr int q = 0;
  static constexpr int g = q + tile_bytes<D, kQRows>();  // dout
  static constexpr int k = g + tile_bytes<D, kQRows>();
  static constexpr int v = k + kStages * tile_bytes<D, kKeys>();
  static constexpr int bars = v + kStages * tile_bytes<D, kKeys>();  // own_full, full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

// DROP: the replayed hash dropout of the probabilities (attention_block in
// training): the row part of the hash once per query row, the keep bit per
// accumulator element; compiled out of every other instantiation.
template <int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mg,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv, FlashBwdArgs a,
                              Drop drop) {
  using P = DqPlan<D>;
  constexpr int KT = kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t Qs = hp::smem_u32(smem + P::q), Gs = hp::smem_u32(smem + P::g),
                 Ks = hp::smem_u32(smem + P::k), Vs = hp::smem_u32(smem + P::v),
                 bars = hp::smem_u32(smem + P::bars);
  const uint32_t own_full = bars, full = bars + 8, empty = bars + 8 + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQRows, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.f.Sq, Sk = a.f.Sk;
  const int tiles = (Sk + KT - 1) / KT;

  if (threadIdx.x == 0) {
    hp::mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, kConsumers);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers) {  // the producer warpgroup: one lane issues every copy
    hp::setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers || lane != 0) return;
    hp::mbar_arrive_expect_tx(own_full, 2 * tile_bytes<D, kQRows>());
    load_tile<D, kQRows>(Qs, &mq, own_full, h, q0, b);
    load_tile<D, kQRows>(Gs, &mg, own_full, h, q0, b);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) hp::mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
      hp::mbar_arrive_expect_tx(full + 8 * s, 2 * tile_bytes<D, KT>());
      load_tile<D, KT>(Ks + s * tile_bytes<D, KT>(), &mk, full + 8 * s, h, t * KT, b);
      load_tile<D, KT>(Vs + s * tile_bytes<D, KT>(), &mv, full + 8 * s, h, t * KT, b);
    }
    return;
  }

  hp::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const Lane ln;
  const int row0 = q0 + wg * 64 + ln.r, row1 = row0 + 8;  // this thread's two query rows
  const size_t bh = (size_t)b * a.f.H + h;
  // row statistics; a row past Sq, or one whose sum is 0, gets p = 0
  float m0 = 0.0f, m1 = 0.0f, il0 = 0.0f, il1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;
  if (row0 < Sq) {
    const float l = a.l[bh * Sq + row0];
    m0 = a.m[bh * Sq + row0];
    il0 = l > 0.0f ? 1.0f / l : 0.0f;
    dl0 = a.delta[bh * Sq + row0];
  }
  if (row1 < Sq) {
    const float l = a.l[bh * Sq + row1];
    m1 = a.m[bh * Sq + row1];
    il1 = l > 0.0f ? 1.0f / l : 0.0f;
    dl1 = a.delta[bh * Sq + row1];
  }
  const float* bias0 = nullptr;
  const float* bias1 = nullptr;
  if constexpr (BIAS) {
    const float* base = a.f.bias + b * a.f.bb + h * a.f.bh;
    bias0 = base + (long long)min(row0, Sq - 1) * a.f.bq;
    bias1 = base + (long long)min(row1, Sq - 1) * a.f.bq;
  }
  float* ds0 = a.ds ? a.ds + (bh * Sq + min(row0, Sq - 1)) * Sk : nullptr;
  float* ds1 = a.ds ? a.ds + (bh * Sq + min(row1, Sq - 1)) * Sk : nullptr;
  const float scale = a.f.scale;
  uint32_t hash0 = 0, hash1 = 0;  // the row part of the dropout hash
  if constexpr (DROP) {
    const uint32_t seed = (uint32_t)*drop.seed;
    hash0 = hash_row(seed, (uint32_t)bh, row0);
    hash1 = hash_row(seed, (uint32_t)bh, row1);
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  hp::mbar_wait(own_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages, k0 = t * KT;
    const uint32_t Kt = Ks + s * tile_bytes<D, KT>(), Vt = Vs + s * tile_bytes<D, KT>();
    hp::mbar_wait(full + 8 * s, (t / kStages) & 1);
    float sc[KT / 2], dp[KT / 2];
    hp::wgmma_fence();
    mma_over_d<D, kQRows, KT>(sc, Qs, wg * 64, Kt);
    mma_over_d<D, kQRows, KT>(dp, Gs, wg * 64, Vt);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);

    uint32_t dsr[KT / 4];
    const bool ragged = k0 + KT > Sk;
    // the bias's key stride is 1: this tile's row pointer plus a constant
    const float* b0 = BIAS ? bias0 + k0 + ln.c : nullptr;
    const float* b1 = BIAS ? bias1 + k0 + ln.c : nullptr;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      float d0[2], d1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + ln.c + e;
        const bool key = !ragged || col < Sk;
        float x0 = sc[4 * j + e] * scale, x1 = sc[4 * j + 2 + e] * scale;
        if constexpr (BIAS) {
          if (key) {
            x0 += b0[8 * j + e];
            x1 += b1[8 * j + e];
          }
        }
        const float p0 = key ? __expf(x0 - m0) * il0 : 0.0f;
        const float p1 = key ? __expf(x1 - m1) * il1 : 0.0f;
        float g0 = dp[4 * j + e], g1 = dp[4 * j + 2 + e];
        if constexpr (DROP) {  // d(p dropped) / dp: 1 / (1 - rate) where kept, 0 where dropped
          g0 = hash_row_keep(hash0, col, drop.thresh) ? g0 * drop.scale : 0.0f;
          g1 = hash_row_keep(hash1, col, drop.thresh) ? g1 * drop.scale : 0.0f;
        }
        d0[e] = p0 * (g0 - dl0);
        d1[e] = p1 * (g1 - dl1);
        if (ds0 && key) {  // the unscaled score gradient is the bias gradient
          if (row0 < Sq) ds0[col] = d0[e];
          if (row1 < Sq) ds1[col] = d1[e];
        }
      }
      dsr[2 * j] = hp::pack_bf16(d0[0] * scale, d0[1] * scale);
      dsr[2 * j + 1] = hp::pack_bf16(d1[0] * scale, d1[1] * scale);
    }

    hp::fence_regs(dq);
    hp::wgmma_fence();
    mma_over_rows<D, KT>(dq, dsr, Kt);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dq);
    if (lane == 0) hp::mbar_arrive(empty + 8 * s);
  }

  bf16* dQ = head_rows<bf16>(a.dq, a.sdq, b, h, D) + (size_t)(q0 + wg * 64) * a.sdq.token;
  store_acc<D>(dq, dQ, a.sdq.token, Sq - (q0 + wg * 64), ln, 1.0f, 1.0f);
}

// Builds the four tensor maps (per call, on the host) and launches.
template <int D, bool BIAS, bool DROP>
int launch_dq(const FlashBwdArgs& a, const Drop& drop, int B, cudaStream_t st) {
  constexpr int bytes = DqPlan<D>::bytes;
  static const int allowed = allow_smem(flash_bwd_dq_wgmma_kernel<D, BIAS, DROP>, bytes);
  if (allowed != 0) return allowed;
  CUtensorMap mq, mg, mk, mv;
  const FlashArgs& f = a.f;
  if (int e = make_rows_map(&mq, f.q, f.sq, B, f.Sq, f.H, D, kQRows)) return e;
  if (int e = make_rows_map(&mg, a.dout, a.sdo, B, f.Sq, f.H, D, kQRows)) return e;
  if (int e = make_rows_map(&mk, f.k, f.sk, B, f.Sk, f.H, D, kKeys)) return e;
  if (int e = make_rows_map(&mv, f.v, f.sv, B, f.Sk, f.H, D, kKeys)) return e;
  const dim3 grid((f.Sq + kQRows - 1) / kQRows, f.H, B);
  flash_bwd_dq_wgmma_kernel<D, BIAS, DROP>
      <<<grid, kDqThreads, bytes, st>>>(mq, mg, mk, mv, a, drop);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace dq
}  // namespace flashw
}  // namespace smm

