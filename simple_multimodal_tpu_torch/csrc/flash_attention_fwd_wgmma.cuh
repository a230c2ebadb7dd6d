// The forward wgmma flash-attention kernel (bf16, head widths 64, 96, 128),
// as a template that two sources instantiate: flash_attention_wgmma.cu
// (flash_attention, with and without a bias) and attention_core_wgmma.cu
// (the core of attention_block with the hash dropout of its probabilities).
// The design note is at the top of flash_attention_wgmma.cu; what the three
// wgmma flash kernels share is in flash_attention_wgmma.cuh.
#pragma once

#include "flash_attention_wgmma.cuh"

namespace smm {
namespace flashw {

constexpr int kQRows = 128;                  // query rows per block: two warpgroups
constexpr int kConsumers = kQRows / 64 * 4;  // consumer warps
// two consumer warpgroups and a producer warpgroup (one warp of it works):
// a block of 9 warps is given registers as one of 12, 168 a thread, so the
// producer is a whole warpgroup that hands its registers to the consumers
constexpr int kFwdThreads = kConsumers * 32 + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Keys per streamed tile, from ptxas' register counts (zero spill bytes):
// 128 scores a row beside the dropout hash spill at D = 64 and 96.
template <int D, bool DROP = false>
constexpr int fwd_keys() { return D <= 96 && !DROP ? 128 : 64; }

template <int D, bool DROP = false>
struct FwdPlan {
  static constexpr int KT = fwd_keys<D, DROP>();
  static constexpr int q = 0;
  static constexpr int k = q + tile_bytes<D, kQRows>();
  static constexpr int v = k + kStages * tile_bytes<D, KT>();
  static constexpr int bars = v + kStages * tile_bytes<D, KT>();  // q_full, full[], empty[]
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

// DROP: the hash dropout of the probabilities (attention_block in training),
// compiled out of every other instantiation.
template <int D, bool BIAS, bool DROP>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv, FlashArgs a, FlashOut w,
                           Drop drop) {
  using P = FwdPlan<D, DROP>;
  constexpr int KT = P::KT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t Qs = hp::smem_u32(smem + P::q), Ks = hp::smem_u32(smem + P::k),
                 Vs = hp::smem_u32(smem + P::v), bars = hp::smem_u32(smem + P::bars);
  const uint32_t q_full = bars, full = bars + 8, empty = bars + 8 + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQRows, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const int tiles = (Sk + KT - 1) / KT;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, kConsumers);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers) {  // the producer warpgroup: one lane starts every copy
    hp::setmaxnreg_dec<kProducerRegs>();
    if (warp != kConsumers || lane != 0) return;
    hp::mbar_arrive_expect_tx(q_full, tile_bytes<D, kQRows>());
    load_tile<D, kQRows>(Qs, &mq, q_full, h, q0, b);
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
  const float* bias0 = nullptr;
  const float* bias1 = nullptr;
  if constexpr (BIAS) {
    const float* base = a.bias + b * a.bb + h * a.bh;
    bias0 = base + (long long)min(row0, Sq - 1) * a.bq;
    bias1 = base + (long long)min(row1, Sq - 1) * a.bq;
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = kMaskFill, m1 = kMaskFill, l0 = 0.0f, l1 = 0.0f;  // l: this lane's share
  uint32_t hash0 = 0, hash1 = 0;  // the row part of the dropout hash
  if constexpr (DROP) {
    const uint32_t seed = (uint32_t)*drop.seed, head = (uint32_t)(b * a.H + h);
    hash0 = hash_row(seed, head, row0);
    hash1 = hash_row(seed, head, row1);
  }

  hp::mbar_wait(q_full, 0);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages, k0 = t * KT;
    hp::mbar_wait(full + 8 * s, (t / kStages) & 1);
    float sc[KT / 2];
    hp::wgmma_fence();
    mma_over_d<D, kQRows, KT>(sc, Qs, wg * 64, Ks + s * tile_bytes<D, KT>());
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);

    // scaled, biased scores; a key past Sk gets -inf (weight 0)
    const bool ragged = k0 + KT > Sk;
    float mx0 = m0, mx1 = m1;
    // the bias's key stride is 1 (the wrapper sees to it): every load is
    // this tile's row pointer plus a constant
    const float* b0 = BIAS ? bias0 + k0 + ln.c : nullptr;
    const float* b1 = BIAS ? bias1 + k0 + ln.c : nullptr;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + ln.c + e;
        float x0 = sc[4 * j + e] * a.scale, x1 = sc[4 * j + 2 + e] * a.scale;
        if constexpr (BIAS) {
          if (!ragged || col < Sk) {
            x0 += b0[8 * j + e];
            x1 += b1[8 * j + e];
          }
        }
        if (ragged && col >= Sk) x0 = x1 = -INFINITY;
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = __expf(m0 - mx0), alpha1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
    uint32_t p[KT / 4];
#pragma unroll
    for (int n = 0; n < KT / 4; ++n) {  // pairs of neighbouring columns: even n row 0, odd n row 1
      const float mx = (n & 1) ? mx1 : mx0;
      float pa = __expf(sc[2 * n] - mx), pb = __expf(sc[2 * n + 1] - mx);
      if (n & 1) sum1 += pa + pb; else sum0 += pa + pb;
      if constexpr (DROP) {
        // after the row sum of all exponentials, before the bf16 rounding:
        // a kept probability is scaled by 1 / (1 - rate), a dropped one is 0
        const uint32_t hr = (n & 1) ? hash1 : hash0;
        const uint32_t col = k0 + 8 * (n >> 1) + ln.c;
        pa = hash_row_keep(hr, col, drop.thresh) ? pa * drop.scale : 0.0f;
        pb = hash_row_keep(hr, col + 1, drop.thresh) ? pb * drop.scale : 0.0f;
      }
      p[n] = hp::pack_bf16(pa, pb);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    hp::fence_regs(o);
    hp::wgmma_fence();
    mma_over_rows<D, KT>(o, p, Vs + s * tile_bytes<D, KT>());
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
    if (lane == 0) hp::mbar_arrive(empty + 8 * s);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  bf16* O = head_rows<bf16>(w.out, w.so, b, h, D) + (size_t)(q0 + wg * 64) * w.so.token;
  store_acc<D>(o, O, w.so.token, Sq - (q0 + wg * 64), ln, l0 > 0.0f ? 1.0f / l0 : 0.0f,
               l1 > 0.0f ? 1.0f / l1 : 0.0f);
  if (w.m && (lane & 3) == 0) {  // the row statistics, for a caller with a backward
    const size_t i = ((size_t)b * a.H + h) * Sq;
    if (row0 < Sq) {
      w.m[i + row0] = m0;
      w.l[i + row0] = l0;
    }
    if (row1 < Sq) {
      w.m[i + row1] = m1;
      w.l[i + row1] = l1;
    }
  }
}

// Builds the three tensor maps (per call, on the host) and launches.
template <int D, bool BIAS, bool DROP>
int launch_fwd(const FlashArgs& a, const FlashOut& w, const Drop& drop, int B, cudaStream_t st) {
  constexpr int bytes = FwdPlan<D, DROP>::bytes;
  static const int allowed = allow_smem(flash_fwd_wgmma_kernel<D, BIAS, DROP>, bytes);
  if (allowed != 0) return allowed;
  CUtensorMap mq, mk, mv;
  if (int e = make_rows_map(&mq, a.q, a.sq, B, a.Sq, a.H, D, kQRows)) return e;
  if (int e = make_rows_map(&mk, a.k, a.sk, B, a.Sk, a.H, D, fwd_keys<D, DROP>())) return e;
  if (int e = make_rows_map(&mv, a.v, a.sv, B, a.Sk, a.H, D, fwd_keys<D, DROP>())) return e;
  const dim3 grid((a.Sq + kQRows - 1) / kQRows, a.H, B);
  flash_fwd_wgmma_kernel<D, BIAS, DROP><<<grid, kFwdThreads, bytes, st>>>(mq, mk, mv, a, w, drop);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace flashw
}  // namespace smm
