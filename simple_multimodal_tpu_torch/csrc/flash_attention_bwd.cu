// Flash attention backward for Hopper: dq, dk, dv and, with a bias, the f32
// score gradient dS [B, H, Sq, Sk] that the wrapper reduces over the bias's
// broadcast axes.
//
// Replaces simple_multimodal_tpu/ops/pallas/flash_attention.py,
// `_bwd_dkv_kernel` and `_bwd_dq_kernel` via `_flash_backward`. Like the TPU
// kernels it stores no probabilities: from the saved output and the row
// statistics m, l (flash_attention.cu says why not their sum lse)
//   delta = rowsum(dout * out)                    (f32, one warp per row)
//   p  = exp(q k^T / sqrt(D) + bias - m) / l      (0 at keys past Sk)
//   dv = p^T dout,  dp = dout v^T,  ds = p * (dp - delta)
//   dq = ds k / sqrt(D),  dk = ds^T q / sqrt(D),  dbias = ds
// are recomputed tile by tile. Two kernels own 64-row tiles, so every output
// is summed by one block in a fixed order and no atomics are needed: dq (and
// dS) per query tile streaming key tiles, dk/dv per key tile streaming query
// tiles. Operands are read in their [B, S, H, D] layout through strides and
// the bias through its own strides (0 on a broadcast axis); the TPU
// kernels' head groups, padded blocks and the VMEM sizing of the bias tiles
// (`_bwd_bias_blocks`) have no counterpart.
//
// What bounds it on this card: operations, 10 Sq Sk D FLOP per (batch,
// head) in five products (two of them computed in both kernels, so 14 are
// executed). This file holds the C entry point and the bodies for f32 and
// the head widths 4 and 8 (exact FMA loops) and for bf16 at D = 16 and 32
// (WMMA, f32 accumulators; p and ds rounded to bf16 before they meet dout,
// k and q, as the TPU kernel rounds them); bf16 at D = 64, 96 and 128 runs
// flash_attention_bwd_dq_wgmma.cu and flash_attention_bwd_dkv_wgmma.cu
// after the delta kernel. With a full bias the dS write (4 B H Sq Sk bytes)
// comes on top.

#include "attention_bwd.cuh"
#include "flash_attention.cuh"

namespace {

using namespace smm;

// m, 1/l and delta of the 64 query rows from q0 into St[0|64|128 + r]; a
// row whose sum is 0 gets probability 0 everywhere.
__device__ __forceinline__ void stage_row_stats(const FlashBwdArgs& a, float* St, size_t bh,
                                                int q0) {
  for (int r = threadIdx.x; r < kTQ; r += kAttnThreads) {
    const bool ok = q0 + r < a.f.Sq;
    const size_t i = bh * a.f.Sq + q0 + r;
    const float l = ok ? a.l[i] : 0.0f;
    St[r] = ok ? a.m[i] : 0.0f;
    St[kTQ + r] = l > 0.0f ? 1.0f / l : 0.0f;
    St[2 * kTQ + r] = ok ? a.delta[i] : 0.0f;
  }
}

// One (q, k) element: ds (unscaled, also the bias gradient) and p; zeros
// outside the two lengths.
__device__ __forceinline__ DsPd flash_ds(const FlashBwdArgs& a, float qk, float dp,
                                         const float* St, int row, int b, int h, int q, int k) {
  if (q >= a.f.Sq || k >= a.f.Sk) return {0.0f, 0.0f};
  const float delta = St[2 * kTQ + row];
  const float p = __expf(flash_score(a.f, qk, b, h, q, k) - St[row]) * St[kTQ + row];
  return {p * (dp - delta), p};
}

__device__ __forceinline__ void store_ds(const FlashBwdArgs& a, size_t bh, int q, int k,
                                         float ds) {
  if (a.ds && q < a.f.Sq && k < a.f.Sk) a.ds[(bh * a.f.Sq + q) * a.f.Sk + k] = ds;
}

// ------------------------------------------------------------- bf16, WMMA

template <int D>
__global__ void __launch_bounds__(kAttnThreads) flash_bwd_dq_wmma_kernel(FlashBwdArgs a) {
  using namespace nvcuda;
  using P = BwdWmmaPlan<D, false>;
  constexpr int LDB = P::LDB, LDS = P::LDS, LDP = P::LDP, KD = D / 16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qs = (bf16*)(smem_raw + P::own0);
  bf16* DAs = (bf16*)(smem_raw + P::own1);
  bf16* Ks = (bf16*)(smem_raw + P::str0);
  bf16* Vs = (bf16*)(smem_raw + P::str1);
  float* Sw = (float*)(smem_raw + P::s) + warp * 16 * LDS;
  float* DPw = (float*)(smem_raw + P::dp) + warp * 16 * LDS;
  bf16* DSw = (bf16*)(smem_raw + P::ds) + warp * 16 * LDP;
  float* St = (float*)(smem_raw + P::st);

  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.f.Sq, Sk = a.f.Sk;
  const size_t bh = (size_t)b * a.f.H + h;
  const bf16* Q = head_rows<bf16>(a.f.q, a.f.sq, b, h, D);
  const bf16* K = head_rows<bf16>(a.f.k, a.f.sk, b, h, D);
  const bf16* V = head_rows<bf16>(a.f.v, a.f.sv, b, h, D);
  const bf16* DO = head_rows<bf16>(a.dout, a.sdo, b, h, D);
  stage_rows<D, LDB>(Qs, kTQ, [&](int r) -> const bf16* {
    return q0 + r < Sq ? Q + (size_t)(q0 + r) * a.f.sq.token : nullptr;
  });
  stage_rows<D, LDB>(DAs, kTQ, [&](int r) -> const bf16* {
    return q0 + r < Sq ? DO + (size_t)(q0 + r) * a.sdo.token : nullptr;
  });
  stage_row_stats(a, St, bh, q0);
  __syncthreads();
  FragA qf[KD], gf[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LDB + kk * 16, LDB);
    wmma::load_matrix_sync(gf[kk], DAs + warp * 16 * LDB + kk * 16, LDB);
  }
  FragC acc[KD];
#pragma unroll
  for (int j = 0; j < KD; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < Sk; k0 += kTK) {
    __syncthreads();
    stage_rows<D, LDB>(Ks, kTK, [&](int r) -> const bf16* {
      return k0 + r < Sk ? K + (size_t)(k0 + r) * a.f.sk.token : nullptr;
    });
    stage_rows<D, LDB>(Vs, kTK, [&](int r) -> const bf16* {
      return k0 + r < Sk ? V + (size_t)(k0 + r) * a.f.sv.token : nullptr;
    });
    __syncthreads();
    FragC c;
#pragma unroll
    for (int j = 0; j < kTK / 16; ++j) {
      FragBt kb;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::load_matrix_sync(kb, Ks + j * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(c, qf[kk], kb, c);
      }
      wmma::store_matrix_sync(Sw + j * 16, c, LDS, wmma::mem_row_major);
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::load_matrix_sync(kb, Vs + j * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(c, gf[kk], kb, c);
      }
      wmma::store_matrix_sync(DPw + j * 16, c, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cc = lane + 32 * jj, kg = k0 + cc, ql = warp * 16 + r, qg = q0 + ql;
        const float ds = flash_ds(a, Sw[r * LDS + cc], DPw[r * LDS + cc], St, ql, b, h, qg, kg).ds;
        store_ds(a, bh, qg, kg, ds);
        DSw[r * LDP + cc] = __float2bfloat16(ds * a.f.scale);
      }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        FragA da_;
        FragB kb;
        wmma::load_matrix_sync(da_, DSw + kk * 16, LDP);
        wmma::load_matrix_sync(kb, Ks + kk * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(acc[j], da_, kb, acc[j]);
      }
  }
  store_rows<D, LDS>(acc, Sw, head_rows<bf16>(a.dq, a.sdq, b, h, D), 0, q0 + warp * 16, Sq,
                     (int)a.sdq.token, 0);
}

// dk and dv with the key tile's rows as the MMA rows (s^T = K Q^T,
// dp^T = V dout^T).
template <int D>
__global__ void __launch_bounds__(kAttnThreads) flash_bwd_dkv_wmma_kernel(FlashBwdArgs a) {
  using namespace nvcuda;
  using P = BwdWmmaPlan<D, false>;
  constexpr int LDB = P::LDB, LDS = P::LDS, LDP = P::LDP, KD = D / 16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = (bf16*)(smem_raw + P::own0);
  bf16* Vs = (bf16*)(smem_raw + P::own1);
  bf16* Qs = (bf16*)(smem_raw + P::str0);
  bf16* DAs = (bf16*)(smem_raw + P::str1);
  float* Sw = (float*)(smem_raw + P::s) + warp * 16 * LDS;
  float* DPw = (float*)(smem_raw + P::dp) + warp * 16 * LDS;
  bf16* DSw = (bf16*)(smem_raw + P::ds) + warp * 16 * LDP;
  bf16* PDw = (bf16*)(smem_raw + P::pd) + warp * 16 * LDP;
  float* St = (float*)(smem_raw + P::st);

  const int k0 = blockIdx.x * kTK, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.f.Sq, Sk = a.f.Sk;
  const size_t bh = (size_t)b * a.f.H + h;
  const bf16* Q = head_rows<bf16>(a.f.q, a.f.sq, b, h, D);
  const bf16* K = head_rows<bf16>(a.f.k, a.f.sk, b, h, D);
  const bf16* V = head_rows<bf16>(a.f.v, a.f.sv, b, h, D);
  const bf16* DO = head_rows<bf16>(a.dout, a.sdo, b, h, D);
  stage_rows<D, LDB>(Ks, kTK, [&](int r) -> const bf16* {
    return k0 + r < Sk ? K + (size_t)(k0 + r) * a.f.sk.token : nullptr;
  });
  stage_rows<D, LDB>(Vs, kTK, [&](int r) -> const bf16* {
    return k0 + r < Sk ? V + (size_t)(k0 + r) * a.f.sv.token : nullptr;
  });
  __syncthreads();
  FragA kf[KD], vf[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    wmma::load_matrix_sync(kf[kk], Ks + warp * 16 * LDB + kk * 16, LDB);
    wmma::load_matrix_sync(vf[kk], Vs + warp * 16 * LDB + kk * 16, LDB);
  }
  FragC ak[KD], av[KD];
#pragma unroll
  for (int j = 0; j < KD; ++j) {
    wmma::fill_fragment(ak[j], 0.0f);
    wmma::fill_fragment(av[j], 0.0f);
  }

  for (int q0 = 0; q0 < Sq; q0 += kTQ) {
    __syncthreads();
    stage_rows<D, LDB>(Qs, kTQ, [&](int r) -> const bf16* {
      return q0 + r < Sq ? Q + (size_t)(q0 + r) * a.f.sq.token : nullptr;
    });
    stage_rows<D, LDB>(DAs, kTQ, [&](int r) -> const bf16* {
      return q0 + r < Sq ? DO + (size_t)(q0 + r) * a.sdo.token : nullptr;
    });
    stage_row_stats(a, St, bh, q0);
    __syncthreads();
    FragC c;
#pragma unroll
    for (int j = 0; j < kTQ / 16; ++j) {
      FragBt qb;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::load_matrix_sync(qb, Qs + j * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(c, kf[kk], qb, c);
      }
      wmma::store_matrix_sync(Sw + j * 16, c, LDS, wmma::mem_row_major);
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::load_matrix_sync(qb, DAs + j * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(c, vf[kk], qb, c);
      }
      wmma::store_matrix_sync(DPw + j * 16, c, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cc = lane + 32 * jj, qg = q0 + cc, kg = k0 + warp * 16 + r;
        const DsPd e = flash_ds(a, Sw[r * LDS + cc], DPw[r * LDS + cc], St, cc, b, h, qg, kg);
        DSw[r * LDP + cc] = __float2bfloat16(e.ds * a.f.scale);
        PDw[r * LDP + cc] = __float2bfloat16(e.pd);
      }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int kk = 0; kk < kTQ / 16; ++kk) {
        FragA pa;
        FragB qb;
        wmma::load_matrix_sync(pa, DSw + kk * 16, LDP);
        wmma::load_matrix_sync(qb, Qs + kk * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(ak[j], pa, qb, ak[j]);
        wmma::load_matrix_sync(pa, PDw + kk * 16, LDP);
        wmma::load_matrix_sync(qb, DAs + kk * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(av[j], pa, qb, av[j]);
      }
  }
  const int row0 = k0 + warp * 16;
  store_rows<D, LDS>(ak, Sw, head_rows<bf16>(a.dk, a.sdk, b, h, D), 0, row0, Sk,
                     (int)a.sdk.token, 0);
  store_rows<D, LDS>(av, Sw, head_rows<bf16>(a.dv, a.sddv, b, h, D), 0, row0, Sk,
                     (int)a.sddv.token, 0);
}

// ------------------------- f32 (and head widths below 16), FMA loops

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads) flash_bwd_dq_kernel(FlashBwdArgs a) {
  constexpr int LD = D + 1, DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* DAs = Qs + kTQ * LD;
  float* Ks = DAs + kTQ * LD;
  float* Vs = Ks + kTK * LD;
  float* Ps = Vs + kTK * LD;
  float* St = Ps + 4 * 16 * kTK;  // m, 1/l, delta of the own rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.f.Sq, Sk = a.f.Sk;
  const size_t bh = (size_t)b * a.f.H + h;
  const T* Q = head_rows<T>(a.f.q, a.f.sq, b, h, D);
  const T* K = head_rows<T>(a.f.k, a.f.sk, b, h, D);
  const T* V = head_rows<T>(a.f.v, a.f.sv, b, h, D);
  const T* DO = head_rows<T>(a.dout, a.sdo, b, h, D);

  stage_f32<T, D, LD>(Qs, kTQ, [&](int r) -> const T* {
    return q0 + r < Sq ? Q + (size_t)(q0 + r) * a.f.sq.token : nullptr;
  });
  stage_f32<T, D, LD>(DAs, kTQ, [&](int r) -> const T* {
    return q0 + r < Sq ? DO + (size_t)(q0 + r) * a.sdo.token : nullptr;
  });
  stage_row_stats(a, St, bh, q0);
  float acc[16][DPL];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.0f;
  float* P = Ps + warp * 16 * kTK;
  const float* Qw = Qs + warp * 16 * LD;
  const float* DAw = DAs + warp * 16 * LD;

  for (int k0 = 0; k0 < Sk; k0 += kTK) {
    __syncthreads();
    stage_f32<T, D, LD>(Ks, kTK, [&](int r) -> const T* {
      return k0 + r < Sk ? K + (size_t)(k0 + r) * a.f.sk.token : nullptr;
    });
    stage_f32<T, D, LD>(Vs, kTK, [&](int r) -> const T* {
      return k0 + r < Sk ? V + (size_t)(k0 + r) * a.f.sv.token : nullptr;
    });
    __syncthreads();

    float sc[16][2], dp[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * LD + d], kb = Ks[(lane + 32) * LD + d];
      const float va = Vs[lane * LD + d], vb = Vs[(lane + 32) * LD + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = Qw[r * LD + d], gv = DAw[r * LD + d];
        sc[r][0] = fmaf(qv, ka, sc[r][0]);
        sc[r][1] = fmaf(qv, kb, sc[r][1]);
        dp[r][0] = fmaf(gv, va, dp[r][0]);
        dp[r][1] = fmaf(gv, vb, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, kg = k0 + c, ql = warp * 16 + r, qg = q0 + ql;
        const float ds = flash_ds(a, sc[r][j], dp[r][j], St, ql, b, h, qg, kg).ds;
        store_ds(a, bh, qg, kg, ds);
        P[r * kTK + c] = ds * a.f.scale;
      }
    __syncwarp();
    for (int c = 0; c < kTK; ++c) {
      float kv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        kv[j] = d < D ? Ks[c * LD + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = P[r * kTK + c];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[r][j] = fmaf(p, kv[j], acc[r][j]);
      }
    }
    __syncwarp();
  }
  T* dQ = head_rows<T>(a.dq, a.sdq, b, h, D);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + warp * 16 + r;
    if (s >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) dQ[(size_t)s * a.sdq.token + d] = from_f32<T>(acc[r][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads) flash_bwd_dkv_kernel(FlashBwdArgs a) {
  constexpr int LD = D + 1, DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTK * LD;
  float* Qs = Vs + kTK * LD;
  float* DAs = Qs + kTQ * LD;
  float* Pd = DAs + kTQ * LD;     // [4][16][64] ds
  float* Pp = Pd + 4 * 16 * kTQ;  // [4][16][64] p
  float* St = Pp + 4 * 16 * kTQ;  // m, 1/l, delta of the streamed queries

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kTK, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.f.Sq, Sk = a.f.Sk;
  const size_t bh = (size_t)b * a.f.H + h;
  const T* Q = head_rows<T>(a.f.q, a.f.sq, b, h, D);
  const T* K = head_rows<T>(a.f.k, a.f.sk, b, h, D);
  const T* V = head_rows<T>(a.f.v, a.f.sv, b, h, D);
  const T* DO = head_rows<T>(a.dout, a.sdo, b, h, D);

  stage_f32<T, D, LD>(Ks, kTK, [&](int r) -> const T* {
    return k0 + r < Sk ? K + (size_t)(k0 + r) * a.f.sk.token : nullptr;
  });
  stage_f32<T, D, LD>(Vs, kTK, [&](int r) -> const T* {
    return k0 + r < Sk ? V + (size_t)(k0 + r) * a.f.sv.token : nullptr;
  });
  float ak[16][DPL], av[16][DPL];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < DPL; ++j) ak[r][j] = av[r][j] = 0.0f;
  float* PdW = Pd + warp * 16 * kTQ;
  float* PpW = Pp + warp * 16 * kTQ;
  const float* Kw = Ks + warp * 16 * LD;
  const float* Vw = Vs + warp * 16 * LD;

  for (int q0 = 0; q0 < Sq; q0 += kTQ) {
    __syncthreads();
    stage_f32<T, D, LD>(Qs, kTQ, [&](int r) -> const T* {
      return q0 + r < Sq ? Q + (size_t)(q0 + r) * a.f.sq.token : nullptr;
    });
    stage_f32<T, D, LD>(DAs, kTQ, [&](int r) -> const T* {
      return q0 + r < Sq ? DO + (size_t)(q0 + r) * a.sdo.token : nullptr;
    });
    stage_row_stats(a, St, bh, q0);
    __syncthreads();

    // rows: this warp's 16 keys; lanes: queries (lane, lane + 32)
    float sc[16][2], dp[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qa = Qs[lane * LD + d], qb = Qs[(lane + 32) * LD + d];
      const float ga = DAs[lane * LD + d], gb = DAs[(lane + 32) * LD + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float kv = Kw[r * LD + d], vv = Vw[r * LD + d];
        sc[r][0] = fmaf(qa, kv, sc[r][0]);
        sc[r][1] = fmaf(qb, kv, sc[r][1]);
        dp[r][0] = fmaf(ga, vv, dp[r][0]);
        dp[r][1] = fmaf(gb, vv, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, qg = q0 + c, kg = k0 + warp * 16 + r;
        const DsPd e = flash_ds(a, sc[r][j], dp[r][j], St, c, b, h, qg, kg);
        PdW[r * kTQ + c] = e.ds * a.f.scale;
        PpW[r * kTQ + c] = e.pd;
      }
    __syncwarp();
    for (int c = 0; c < kTQ; ++c) {
      float qv[DPL], gv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        qv[j] = d < D ? Qs[c * LD + d] : 0.0f;
        gv[j] = d < D ? DAs[c * LD + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float ds = PdW[r * kTQ + c], pd = PpW[r * kTQ + c];
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          ak[r][j] = fmaf(ds, qv[j], ak[r][j]);
          av[r][j] = fmaf(pd, gv[j], av[r][j]);
        }
      }
    }
    __syncwarp();
  }
  T* dK = head_rows<T>(a.dk, a.sdk, b, h, D);
  T* dV = head_rows<T>(a.dv, a.sddv, b, h, D);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = k0 + warp * 16 + r;
    if (s >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        dK[(size_t)s * a.sdk.token + d] = from_f32<T>(ak[r][j]);
        dV[(size_t)s * a.sddv.token + d] = from_f32<T>(av[r][j]);
      }
    }
  }
}

template <typename Kern>
int launch_tiles(Kern k, dim3 grid, size_t bytes, const FlashBwdArgs& a, cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, kAttnThreads, bytes, st>>>(a);
  SMM_CHECK_LAUNCH();
  return 0;
}

template <typename T, int D>
int launch_d(const FlashBwdArgs& a, int B, cudaStream_t st) {
  const int rows = B * a.f.Sq * a.f.H;
  flash_delta_kernel<T><<<(rows + 3) / 4, 128, 0, st>>>(a, B, D);
  SMM_CHECK_LAUNCH();
  const dim3 qt((a.f.Sq + kTQ - 1) / kTQ, a.f.H, B), kt((a.f.Sk + kTK - 1) / kTK, a.f.H, B);
  if constexpr (std::is_same<T, bf16>::value && flash_wgmma_width(D)) {
    if (int e = flash_bwd_dq_wgmma_launch(a, B, D, st)) return e;
    return flash_bwd_dkv_wgmma_launch(a, B, D, st);
  } else if constexpr (std::is_same<T, bf16>::value && D % 16 == 0) {
    constexpr size_t bytes = BwdWmmaPlan<D, false>::bytes;
    if (int e = launch_tiles(flash_bwd_dq_wmma_kernel<D>, qt, bytes, a, st)) return e;
    return launch_tiles(flash_bwd_dkv_wmma_kernel<D>, kt, bytes, a, st);
  } else {
    constexpr size_t floats = (size_t)4 * 64 * (D + 1) + 3 * 64;
    if (int e = launch_tiles(flash_bwd_dq_kernel<T, D>, qt,
                             sizeof(float) * (floats + 4 * 16 * 64), a, st))
      return e;
    return launch_tiles(flash_bwd_dkv_kernel<T, D>, kt,
                        sizeof(float) * (floats + 2 * 4 * 16 * 64), a, st);
  }
}

template <typename T>
int launch(const FlashBwdArgs& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 4: return launch_d<T, 4>(a, B, st);
    case 8: return launch_d<T, 8>(a, B, st);
    case 16: return launch_d<T, 16>(a, B, st);
    case 32: return launch_d<T, 32>(a, B, st);
    case 64: return launch_d<T, 64>(a, B, st);
    case 96: return launch_d<T, 96>(a, B, st);
    case 128: return launch_d<T, 128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. q/out/dout/dq [B, Sq, H, D] and k/v/dk/dv
// [B, Sk, H, D] in place; `strides` (host, int64, elements) = batch and token
// stride of q, k, v, out, dout, dq, dk, dv, then the bias's four strides
// over (batch, head, query, key). stats f32 [2, B, H, Sq] from the forward;
// delta f32 [B, H, Sq] scratch; bias f32 or null; ds f32 [B, H, Sq, Sk] (the
// score gradient, written when not null). Returns the first CUDA error, or 0.
extern "C" int smm_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* stats,
                                       const float* bias, float* delta, void* dq, void* dk,
                                       void* dv, float* ds, const long long* strides, int B,
                                       int Sq, int Sk, int H, int D, void* stream) {
  const long long* s = strides;
  FlashBwdArgs a{};
  a.f = FlashArgs{q, k, v, {s[0], s[1]}, {s[2], s[3]}, {s[4], s[5]}, bias, s[16], s[17], s[18],
                  s[19], Sq, Sk, H, 1.0f / sqrtf((float)D)};
  a.out = out;
  a.dout = dout;
  a.so = {s[6], s[7]};
  a.sdo = {s[8], s[9]};
  a.m = stats;
  a.l = stats + (size_t)B * H * Sq;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.sdq = {s[10], s[11]};
  a.sdk = {s[12], s[13]};
  a.sddv = {s[14], s[15]};
  a.ds = ds;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(a, B, D, st) : launch<float>(a, B, D, st);
}
