// Backward of the attention core shared by attention_block_bwd.cu and
// deberta_attention_bwd.cu: given dout (the gradient of softmax(s) . V) it
// computes dq, dk, dv and, with REL, the gradients of DeBERTa's two
// position tables, without storing any [S, S] tensor in device memory.
//
// The forward kernel (attention.cuh) is re-run first with its row-stats
// outputs on: each query row's max m and exponential sum l, and
// delta = dout . ctx. Then every (q, k) element is recomputed where it is
// needed:
//   p  = exp(s - m) / l                 (s masked and scaled as forward)
//   pd = keep ? p / (1 - rate) : 0      (the same hash as forward)
//   dp = dout_q . v_k,  dpd = keep ? dp / (1 - rate) : 0
//   ds = scale * p * (dpd - delta_q)    (0 at masked keys)
// since sum_k dpd p = dout_q . sum_k pd v_k = dout_q . ctx_q.
//
// Three kernels, each owning a tile of 64 rows so that every output is
// summed by one block in a fixed order (no atomics, so the gradients do not
// vary from run to run):
//   dq:  per (query tile, head, batch), streams key tiles:
//        dq_q = sum_k ds (k_k [+ pos_k[idx_c(q-k)]])
//   dkv: per (key tile, head, batch), streams query tiles:
//        dk_k = sum_q ds (q_q [+ pos_q[idx_p(q-k)]]),  dv_k = sum_q pd dout_q
//   rel (REL only): per (tile of 64 offsets r = q - k, head, batch),
//        streams query tiles: gc_r = sum_{q-k=r} ds q_q, gp_r = sum ds k_k.
// The per-offset rows gc/gp are then folded into table rows through the
// host-built CSR of the bucket map (fold_kernel), summing over the batch
// and over the offsets of one bucket in a fixed order. Scattering straight
// into the table with f32 atomicAdd would be shorter but would give a
// different sum on every run; the diagonal sums cost one extra kernel over
// the same elements.
//
// Bounds: each element costs 2 (plain) or 4 (REL) length-D dot products
// recomputed, plus the accumulations. In bf16 every product runs on the
// tensor cores through WMMA (f32 accumulators; ds and the dropped
// probabilities rounded to bf16 before they meet q/k/dout/the tables, as
// the TPU kernel rounds them), the softmax backward in f32; with REL the
// table terms of dq and dk are a skewed ds times the staged table rows,
// and the per-offset kernel gathers each (r, q) element from tensor-core
// tiles. f32 calls run the same algorithm as f32 FMA loops from shared
// memory (exact f32 sums), bound by shared-memory loads and FMA issue at
// one 128-thread block per SM.
#pragma once

#include "attention.cuh"

namespace smm {

struct AttnBwdArgs {
  AttnArgs f;        // q, k, v, strides, S, H, scale, REL tables, mask, drop
  const void* dout;  // [B, S, H, D] rows of ldo elements (f.lddo)
  const float* m;    // [B*H*S] row max, exponential sum and delta
  const float* l;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int lddq, lddk, lddv;
  float* gc;  // REL: [B, H, 2S-1, D]
  float* gp;
};

struct DsPd {
  float ds, pd;
};

__device__ __forceinline__ DsPd ds_elem(const AttnBwdArgs& a, float sraw, float dp, float m,
                                        float l, float dlt, int bh, int q, int k, bool masked) {
  const float s = masked ? kMaskFill : sraw * a.f.scale;
  const float p = __expf(s - m) / l;
  float pd = p, dpd = dp;
  if (a.f.drop.seed) {
    const bool keep = hash_keep((uint32_t)*a.f.drop.seed, bh, q, k, a.f.drop.thresh);
    pd = keep ? p * a.f.drop.scale : 0.0f;
    dpd = keep ? dp * a.f.drop.scale : 0.0f;
  }
  return {masked ? 0.0f : p * (dpd - dlt) * a.f.scale, pd};
}

// Copies `rows` rows of D values (row r from src_row(r), zero when null)
// into an f32 tile of pitch LD.
template <typename T, int D, int LD, typename RowFn>
__device__ __forceinline__ void stage_f32(float* dst, int rows, RowFn src_row) {
  for (int e = threadIdx.x; e < rows * D; e += kAttnThreads) {
    const int r = e / D, d = e % D;
    const T* src = src_row(r);
    dst[r * LD + d] = src ? to_f32(src[d]) : 0.0f;
  }
}

// The <= 127 position-table rows a (query tile q0, key tile k0) pair
// reaches, row u = (q - k) - (q0 - k0 - 63), as the forward stages them.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rel_tables(const AttnArgs& f, float* PKs, float* PQs,
                                                 int q0, int k0, int h) {
  const int S = f.S, rel0 = q0 - k0 - (kTK - 1);
  const T* PK = (const T*)f.pos_k;
  const T* PQ = (const T*)f.pos_q;
  stage_f32<T, D, LD>(PKs, kRelRows, [&](int u) -> const T* {
    const int rel = rel0 + u;
    return rel > -S && rel < S ? PK + (size_t)f.idx_c[rel + S - 1] * f.ldp + h * D : nullptr;
  });
  stage_f32<T, D, LD>(PQs, kRelRows, [&](int u) -> const T* {
    const int rel = rel0 + u;
    return rel > -S && rel < S ? PQ + (size_t)f.idx_p[rel + S - 1] * f.ldp + h * D : nullptr;
  });
}

// m, l and delta of the 64 query rows from q0 into St[0|64|128 + r]
// (neutral values past S).
__device__ __forceinline__ void stage_stats(const AttnBwdArgs& a, float* St, int bh, int q0) {
  const int S = a.f.S;
  for (int r = threadIdx.x; r < kTQ; r += kAttnThreads) {
    const bool ok = q0 + r < S;
    const size_t i = (size_t)bh * S + q0 + r;
    St[r] = ok ? a.m[i] : 0.0f;
    St[kTQ + r] = ok ? a.l[i] : 1.0f;
    St[2 * kTQ + r] = ok ? a.delta[i] : 0.0f;
  }
}

template <int D>
constexpr size_t bwd_smem_floats(bool rel, int pbufs) {
  return (size_t)4 * 64 * (D + 1) + (size_t)pbufs * 4 * 16 * 64 + 3 * 64 +
         (rel ? (size_t)2 * kRelRows * (D + 1) : 0);
}

// ------------------------------------------------------------------ dq

template <typename T, int D, bool REL>
__global__ void __launch_bounds__(kAttnThreads) attn_bwd_dq_kernel(AttnBwdArgs a) {
  constexpr int LD = D + 1, DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* DAs = Qs + kTQ * LD;
  float* Ks = DAs + kTQ * LD;
  float* Vs = Ks + kTK * LD;
  float* Ps = Vs + kTK * LD;
  float* St = Ps + 4 * 16 * kTK;  // m, l, delta of the own rows
  float* PKs = St + 3 * kTQ;
  float* PQs = PKs + kRelRows * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z, S = a.f.S;
  const int bh = b * a.f.H + h;
  const size_t tok0 = (size_t)b * S;
  const T* Q = (const T*)a.f.q;
  const T* K = (const T*)a.f.k;
  const T* V = (const T*)a.f.v;
  const T* DO = (const T*)a.dout;

  stage_f32<T, D, LD>(Qs, kTQ, [&](int r) -> const T* {
    return q0 + r < S ? Q + (tok0 + q0 + r) * a.f.ldq + h * D : nullptr;
  });
  stage_f32<T, D, LD>(DAs, kTQ, [&](int r) -> const T* {
    return q0 + r < S ? DO + (tok0 + q0 + r) * a.f.lddo + h * D : nullptr;
  });
  stage_stats(a, St, bh, q0);
  float acc[16][DPL];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.0f;
  float* P = Ps + warp * 16 * kTK;
  const float* Qw = Qs + warp * 16 * LD;
  const float* DAw = DAs + warp * 16 * LD;

  for (int k0 = 0; k0 < S; k0 += kTK) {
    __syncthreads();
    stage_f32<T, D, LD>(Ks, kTK, [&](int r) -> const T* {
      return k0 + r < S ? K + (tok0 + k0 + r) * a.f.ldk + h * D : nullptr;
    });
    stage_f32<T, D, LD>(Vs, kTK, [&](int r) -> const T* {
      return k0 + r < S ? V + (tok0 + k0 + r) * a.f.ldv + h * D : nullptr;
    });
    if (REL) stage_rel_tables<T, D, LD>(a.f, PKs, PQs, q0, k0, h);
    __syncthreads();

    float sc[16][2], dp[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * LD + d], kb = Ks[(lane + 32) * LD + d];
      const float va = Vs[lane * LD + d], vb = Vs[(lane + 32) * LD + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = Qw[r * LD + d], dv = DAw[r * LD + d];
        sc[r][0] = fmaf(qv, ka, sc[r][0]);
        sc[r][1] = fmaf(qv, kb, sc[r][1]);
        dp[r][0] = fmaf(dv, va, dp[r][0]);
        dp[r][1] = fmaf(dv, vb, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, kg = k0 + c, ql = warp * 16 + r, qg = q0 + ql;
        float ds = 0.0f;
        if (kg < S && qg < S) {
          float s = sc[r][j];
          if (REL) {
            const int u = ql - c + (kTK - 1);
            const float* qr = Qw + r * LD;
            const float* kr = Ks + c * LD;
            const float* pk = PKs + u * LD;
            const float* pq = PQs + u * LD;
            float acc2 = 0.0f;
            for (int d = 0; d < D; ++d) acc2 = fmaf(qr[d], pk[d], fmaf(kr[d], pq[d], acc2));
            s += acc2;
          }
          const bool masked = REL && a.f.mask && a.f.mask[tok0 + kg] == 0;
          ds = ds_elem(a, s, dp[r][j], St[ql], St[kTQ + ql], St[2 * kTQ + ql], bh, qg, kg,
                       masked).ds;
        }
        P[r * kTK + c] = ds;
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
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          float w = kv[j];
          if (REL && d < D) w += PKs[(warp * 16 + r - c + (kTK - 1)) * LD + d];
          acc[r][j] = fmaf(p, w, acc[r][j]);
        }
      }
    }
    __syncwarp();
  }
  T* dQ = (T*)a.dq;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + warp * 16 + r;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) dQ[(tok0 + s) * a.lddq + h * D + d] = from_f32<T>(acc[r][j]);
    }
  }
}

// ----------------------------------------------------------------- dk, dv

template <typename T, int D, bool REL>
__global__ void __launch_bounds__(kAttnThreads) attn_bwd_dkv_kernel(AttnBwdArgs a) {
  constexpr int LD = D + 1, DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTK * LD;
  float* Qs = Vs + kTK * LD;
  float* DAs = Qs + kTQ * LD;
  float* Pd = DAs + kTQ * LD;       // [4][16][64] ds
  float* Pp = Pd + 4 * 16 * kTQ;   // [4][16][64] dropped probabilities
  float* St = Pp + 4 * 16 * kTQ;   // m, l, delta of the streamed queries
  float* PKs = St + 3 * kTQ;
  float* PQs = PKs + kRelRows * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kTK, h = blockIdx.y, b = blockIdx.z, S = a.f.S;
  const int bh = b * a.f.H + h;
  const size_t tok0 = (size_t)b * S;
  const T* Q = (const T*)a.f.q;
  const T* K = (const T*)a.f.k;
  const T* V = (const T*)a.f.v;
  const T* DO = (const T*)a.dout;

  stage_f32<T, D, LD>(Ks, kTK, [&](int r) -> const T* {
    return k0 + r < S ? K + (tok0 + k0 + r) * a.f.ldk + h * D : nullptr;
  });
  stage_f32<T, D, LD>(Vs, kTK, [&](int r) -> const T* {
    return k0 + r < S ? V + (tok0 + k0 + r) * a.f.ldv + h * D : nullptr;
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
  bool masked[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int kg = k0 + warp * 16 + r;
    masked[r] = REL && a.f.mask && kg < S && a.f.mask[tok0 + kg] == 0;
  }

  for (int q0 = 0; q0 < S; q0 += kTQ) {
    __syncthreads();
    stage_f32<T, D, LD>(Qs, kTQ, [&](int r) -> const T* {
      return q0 + r < S ? Q + (tok0 + q0 + r) * a.f.ldq + h * D : nullptr;
    });
    stage_f32<T, D, LD>(DAs, kTQ, [&](int r) -> const T* {
      return q0 + r < S ? DO + (tok0 + q0 + r) * a.f.lddo + h * D : nullptr;
    });
    stage_stats(a, St, bh, q0);
    if (REL) stage_rel_tables<T, D, LD>(a.f, PKs, PQs, q0, k0, h);
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
        const int c = lane + 32 * j, qg = q0 + c, kl = warp * 16 + r, kg = k0 + kl;
        DsPd e = {0.0f, 0.0f};
        if (kg < S && qg < S) {
          float s = sc[r][j];
          if (REL) {
            const int u = c - kl + (kTK - 1);
            const float* qr = Qs + c * LD;
            const float* kr = Kw + r * LD;
            const float* pk = PKs + u * LD;
            const float* pq = PQs + u * LD;
            float acc2 = 0.0f;
            for (int d = 0; d < D; ++d) acc2 = fmaf(qr[d], pk[d], fmaf(kr[d], pq[d], acc2));
            s += acc2;
          }
          e = ds_elem(a, s, dp[r][j], St[c], St[kTQ + c], St[2 * kTQ + c], bh, qg, kg, masked[r]);
        }
        PdW[r * kTQ + c] = e.ds;
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
          const int d = lane + 32 * j;
          float w = qv[j];
          if (REL && d < D) w += PQs[(c - warp * 16 - r + (kTK - 1)) * LD + d];
          ak[r][j] = fmaf(ds, w, ak[r][j]);
          av[r][j] = fmaf(pd, gv[j], av[r][j]);
        }
      }
    }
    __syncwarp();
  }
  T* dK = (T*)a.dk;
  T* dV = (T*)a.dv;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = k0 + warp * 16 + r;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        dK[(tok0 + s) * a.lddk + h * D + d] = from_f32<T>(ak[r][j]);
        dV[(tok0 + s) * a.lddv + h * D + d] = from_f32<T>(av[r][j]);
      }
    }
  }
}

// ------------------------------------------------- bf16 tensor-core bodies

// Shared-memory plan of the WMMA backward kernels (byte offsets,
// 128-aligned): the own and streamed 64-row tiles in bf16; with REL the
// <= 127 (padded to 128) table rows of pos_k and pos_q the tile pair
// reaches; per warp the f32 score and dp tiles (also the epilogue's
// scratch) and the bf16 ds (and, for dk/dv, the dropped probabilities)
// fed back to the tensor cores; with REL the table products (per warp for
// the own rows, shared for the streamed rows) and the skewed ds that
// multiplies the table rows.
template <int D, bool REL>
struct BwdWmmaPlan {
  static constexpr int LDB = D + 8;                    // bf16 row pitch
  static constexpr int LDS = (D > kTK ? D : kTK) + 4;  // f32 pitch
  static constexpr int LDP = kTK + 8;                  // bf16 pitch of ds / pd
  static constexpr int kTab = 128;                     // kRelRows staged, padded
  static constexpr int LDC = kTab + 4;                 // f32 pitch of table products
  static constexpr int LDK = kTab + 8;                 // bf16 pitch of the skewed ds
  static constexpr size_t own0 = 0;
  static constexpr size_t own1 = align128(own0 + 2 * 64 * LDB);
  static constexpr size_t str0 = align128(own1 + 2 * 64 * LDB);
  static constexpr size_t str1 = align128(str0 + 2 * 64 * LDB);
  static constexpr size_t tk = align128(str1 + 2 * 64 * LDB);
  static constexpr size_t tq = align128(tk + (REL ? 2 * kTab * LDB : 0));
  static constexpr size_t s = align128(tq + (REL ? 2 * kTab * LDB : 0));
  static constexpr size_t dp = align128(s + 4 * 4 * 16 * LDS);
  static constexpr size_t cw = align128(dp + 4 * 4 * 16 * LDS);
  static constexpr size_t cs = align128(cw + (REL ? 4 * 4 * 16 * LDC : 0));
  static constexpr size_t ds = align128(cs + (REL ? 4 * 64 * LDC : 0));
  static constexpr size_t pd = align128(ds + 2 * 4 * 16 * LDP);
  static constexpr size_t sk = align128(pd + 2 * 4 * 16 * LDP);
  static constexpr size_t st = align128(sk + (REL ? 2 * 4 * 16 * LDK : 0));
  static constexpr size_t bytes = align128(st + 4 * 3 * 64);
};

// Writes a warp's 16 x D f32 accumulators (staged through `scratch`, pitch
// LDS) as rows of `out` (row r at (tok0 + row0 + r) * ld + col0) for rows
// below `rows`, in the type of `out`.
template <int D, int LDS, typename TOut, typename Frag>
__device__ __forceinline__ void store_rows(Frag (&acc)[D / 16], float* scratch, TOut* out,
                                           size_t tok0, int row0, int rows, int ld, int col0) {
  using namespace nvcuda;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(scratch + j * 16, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, d = e % D;
    if (row0 + r < rows)
      out[(tok0 + row0 + r) * ld + col0 + d] = from_f32<TOut>(scratch[r * LDS + d]);
  }
  __syncwarp();
}

// The table rows a (query tile q0, key tile k0) pair reaches, in bf16:
// row u = (q - k) - (q0 - k0 - 63), zero past the 127 rows and offsets.
template <int D, int LDB>
__device__ __forceinline__ void stage_rel_tables_bf16(const AttnArgs& f, bf16* PKs, bf16* PQs,
                                                      int q0, int k0, int h) {
  const int S = f.S, rel0 = q0 - k0 - (kTK - 1);
  const bf16* PK = (const bf16*)f.pos_k;
  const bf16* PQ = (const bf16*)f.pos_q;
  auto ok = [&](int u) { return u < kRelRows && rel0 + u > -S && rel0 + u < S; };
  stage_rows<D, LDB>(PKs, 128, [&](int u) -> const bf16* {
    return ok(u) ? PK + (size_t)f.idx_c[rel0 + u + S - 1] * f.ldp + h * D : nullptr;
  });
  stage_rows<D, LDB>(PQs, 128, [&](int u) -> const bf16* {
    return ok(u) ? PQ + (size_t)f.idx_p[rel0 + u + S - 1] * f.ldp + h * D : nullptr;
  });
}

// C[16 x 128] (pitch LDC) = A rows (16 x D, pitch LDB) . T^T for the 128
// staged table rows T.
template <int D, int LDB, int LDC, typename FragA>
__device__ __forceinline__ void table_product(const FragA (&af)[D / 16], const bf16* T, float* C) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> tb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
  for (int n = 0; n < 128 / 16; ++n) {
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(tb, T + n * 16 * LDB + kk * 16, LDB);
      wmma::mma_sync(c, af[kk], tb, c);
    }
    wmma::store_matrix_sync(C + n * 16, c, LDC, wmma::mem_row_major);
  }
}

// The skewed ds: column u of row r takes DSw's column c = base + r - u
// (sign > 0) or c = base + r + u (sign < 0), zero where c is outside the
// 64; 128 columns.
template <int LDP, int LDK>
__device__ __forceinline__ void skew_rows(const bf16* DSw, bf16* SKw, int base, int sign) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < 16; ++r)
    for (int u = lane; u < 128; u += 32) {
      const int c = sign > 0 ? base + r - u : base + r + u;
      SKw[r * LDK + u] = c >= 0 && c < 64 ? DSw[r * LDP + c] : __float2bfloat16(0.0f);
    }
}

// dq = sum_k ds (k [+ pos_k[idx_c(q - k)]]) over streamed key tiles; the
// products on the tensor cores (bf16 in, f32 accumulators), the softmax
// backward in f32. With REL the table term is the skewed ds times the
// staged pos_k rows.
template <int D, bool REL>
__global__ void __launch_bounds__(kAttnThreads) attn_bwd_dq_wmma_kernel(AttnBwdArgs a) {
  using namespace nvcuda;
  using P = BwdWmmaPlan<D, REL>;
  constexpr int LDB = P::LDB, LDS = P::LDS, LDP = P::LDP, LDC = P::LDC, LDK = P::LDK;
  constexpr int KD = D / 16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Qs = (bf16*)(smem_raw + P::own0);
  bf16* DAs = (bf16*)(smem_raw + P::own1);
  bf16* Ks = (bf16*)(smem_raw + P::str0);
  bf16* Vs = (bf16*)(smem_raw + P::str1);
  bf16* PKs = (bf16*)(smem_raw + P::tk);
  bf16* PQs = (bf16*)(smem_raw + P::tq);
  float* Sw = (float*)(smem_raw + P::s) + warp * 16 * LDS;
  float* DPw = (float*)(smem_raw + P::dp) + warp * 16 * LDS;
  float* Cw = (float*)(smem_raw + P::cw) + warp * 16 * LDC;  // q_r . PK[u]
  float* Cs = (float*)(smem_raw + P::cs);                    // k_c . PQ[u], every key
  bf16* DSw = (bf16*)(smem_raw + P::ds) + warp * 16 * LDP;
  bf16* SKw = (bf16*)(smem_raw + P::sk) + warp * 16 * LDK;
  float* St = (float*)(smem_raw + P::st);

  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z, S = a.f.S;
  const int bh = b * a.f.H + h;
  const size_t tok0 = (size_t)b * S;
  const bf16* Q = (const bf16*)a.f.q;
  const bf16* K = (const bf16*)a.f.k;
  const bf16* V = (const bf16*)a.f.v;
  const bf16* DO = (const bf16*)a.dout;
  stage_rows<D, LDB>(Qs, kTQ, [&](int r) -> const bf16* {
    return q0 + r < S ? Q + (tok0 + q0 + r) * a.f.ldq + h * D : nullptr;
  });
  stage_rows<D, LDB>(DAs, kTQ, [&](int r) -> const bf16* {
    return q0 + r < S ? DO + (tok0 + q0 + r) * a.f.lddo + h * D : nullptr;
  });
  stage_stats(a, St, bh, q0);
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

  for (int k0 = 0; k0 < S; k0 += kTK) {
    __syncthreads();
    stage_rows<D, LDB>(Ks, kTK, [&](int r) -> const bf16* {
      return k0 + r < S ? K + (tok0 + k0 + r) * a.f.ldk + h * D : nullptr;
    });
    stage_rows<D, LDB>(Vs, kTK, [&](int r) -> const bf16* {
      return k0 + r < S ? V + (tok0 + k0 + r) * a.f.ldv + h * D : nullptr;
    });
    if constexpr (REL) stage_rel_tables_bf16<D, LDB>(a.f, PKs, PQs, q0, k0, h);
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
    if constexpr (REL) {
      FragA kf[KD];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        wmma::load_matrix_sync(kf[kk], Ks + warp * 16 * LDB + kk * 16, LDB);
      table_product<D, LDB, LDC>(qf, PKs, Cw);
      table_product<D, LDB, LDC>(kf, PQs, Cs + warp * 16 * LDC);
      __syncthreads();  // every warp's key rows of Cs
    } else {
      __syncwarp();
    }
#pragma unroll 4
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cc = lane + 32 * jj, kg = k0 + cc, ql = warp * 16 + r, qg = q0 + ql;
        float ds = 0.0f;
        if (kg < S && qg < S) {
          float s = Sw[r * LDS + cc];
          bool masked = false;
          if constexpr (REL) {
            const int u = ql - cc + (kTK - 1);
            s += Cw[r * LDC + u] + Cs[cc * LDC + u];
            masked = a.f.mask && a.f.mask[tok0 + kg] == 0;
          }
          ds = ds_elem(a, s, DPw[r * LDS + cc], St[ql], St[kTQ + ql], St[2 * kTQ + ql], bh, qg,
                       kg, masked).ds;
        }
        DSw[r * LDP + cc] = __float2bfloat16(ds);
      }
    __syncwarp();
    if constexpr (REL) {
      skew_rows<LDP, LDK>(DSw, SKw, warp * 16 + kTK - 1, 1);  // u = ql - c + 63
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < KD; ++j) {
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        FragA da_;
        FragB kb;
        wmma::load_matrix_sync(da_, DSw + kk * 16, LDP);
        wmma::load_matrix_sync(kb, Ks + kk * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(acc[j], da_, kb, acc[j]);
      }
      if constexpr (REL) {
#pragma unroll
        for (int n = 0; n < 128 / 16; ++n) {
          FragA sa;
          FragB tb;
          wmma::load_matrix_sync(sa, SKw + n * 16, LDK);
          wmma::load_matrix_sync(tb, PKs + n * 16 * LDB + j * 16, LDB);
          wmma::mma_sync(acc[j], sa, tb, acc[j]);
        }
      }
    }
  }
  store_rows<D, LDS>(acc, Sw, (bf16*)a.dq, tok0, q0 + warp * 16, S, a.lddq, h * D);
}

// dk = sum_q ds (q [+ pos_q[idx_p(q - k)]]) and dv = sum_q pd dout over
// streamed query tiles, with the key tile's rows as the MMA rows
// (s^T = K Q^T, dp^T = V dout^T).
template <int D, bool REL>
__global__ void __launch_bounds__(kAttnThreads) attn_bwd_dkv_wmma_kernel(AttnBwdArgs a) {
  using namespace nvcuda;
  using P = BwdWmmaPlan<D, REL>;
  constexpr int LDB = P::LDB, LDS = P::LDS, LDP = P::LDP, LDC = P::LDC, LDK = P::LDK;
  constexpr int KD = D / 16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Ks = (bf16*)(smem_raw + P::own0);
  bf16* Vs = (bf16*)(smem_raw + P::own1);
  bf16* Qs = (bf16*)(smem_raw + P::str0);
  bf16* DAs = (bf16*)(smem_raw + P::str1);
  bf16* PKs = (bf16*)(smem_raw + P::tk);
  bf16* PQs = (bf16*)(smem_raw + P::tq);
  float* Sw = (float*)(smem_raw + P::s) + warp * 16 * LDS;
  float* DPw = (float*)(smem_raw + P::dp) + warp * 16 * LDS;
  float* Cw = (float*)(smem_raw + P::cw) + warp * 16 * LDC;  // k_r . PQ[u]
  float* Cs = (float*)(smem_raw + P::cs);                    // q_c . PK[u], every query
  bf16* DSw = (bf16*)(smem_raw + P::ds) + warp * 16 * LDP;
  bf16* PDw = (bf16*)(smem_raw + P::pd) + warp * 16 * LDP;
  bf16* SKw = (bf16*)(smem_raw + P::sk) + warp * 16 * LDK;
  float* St = (float*)(smem_raw + P::st);

  const int k0 = blockIdx.x * kTK, h = blockIdx.y, b = blockIdx.z, S = a.f.S;
  const int bh = b * a.f.H + h;
  const size_t tok0 = (size_t)b * S;
  const bf16* Q = (const bf16*)a.f.q;
  const bf16* K = (const bf16*)a.f.k;
  const bf16* V = (const bf16*)a.f.v;
  const bf16* DO = (const bf16*)a.dout;
  stage_rows<D, LDB>(Ks, kTK, [&](int r) -> const bf16* {
    return k0 + r < S ? K + (tok0 + k0 + r) * a.f.ldk + h * D : nullptr;
  });
  stage_rows<D, LDB>(Vs, kTK, [&](int r) -> const bf16* {
    return k0 + r < S ? V + (tok0 + k0 + r) * a.f.ldv + h * D : nullptr;
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
  bool masked[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int kg = k0 + warp * 16 + r;
    masked[r] = REL && a.f.mask && kg < S && a.f.mask[tok0 + kg] == 0;
  }

  for (int q0 = 0; q0 < S; q0 += kTQ) {
    __syncthreads();
    stage_rows<D, LDB>(Qs, kTQ, [&](int r) -> const bf16* {
      return q0 + r < S ? Q + (tok0 + q0 + r) * a.f.ldq + h * D : nullptr;
    });
    stage_rows<D, LDB>(DAs, kTQ, [&](int r) -> const bf16* {
      return q0 + r < S ? DO + (tok0 + q0 + r) * a.f.lddo + h * D : nullptr;
    });
    stage_stats(a, St, bh, q0);
    if constexpr (REL) stage_rel_tables_bf16<D, LDB>(a.f, PKs, PQs, q0, k0, h);
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
    if constexpr (REL) {
      FragA qa[KD];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * LDB + kk * 16, LDB);
      table_product<D, LDB, LDC>(kf, PQs, Cw);
      table_product<D, LDB, LDC>(qa, PKs, Cs + warp * 16 * LDC);
      __syncthreads();  // every warp's query rows of Cs
    } else {
      __syncwarp();
    }
#pragma unroll 4
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cc = lane + 32 * jj, qg = q0 + cc, kl = warp * 16 + r, kg = k0 + kl;
        DsPd e = {0.0f, 0.0f};
        if (kg < S && qg < S) {
          float s = Sw[r * LDS + cc];
          if constexpr (REL) {
            const int u = cc - kl + (kTK - 1);
            s += Cs[cc * LDC + u] + Cw[r * LDC + u];
          }
          e = ds_elem(a, s, DPw[r * LDS + cc], St[cc], St[kTQ + cc], St[2 * kTQ + cc], bh, qg,
                      kg, masked[r]);
        }
        DSw[r * LDP + cc] = __float2bfloat16(e.ds);
        PDw[r * LDP + cc] = __float2bfloat16(e.pd);
      }
    __syncwarp();
    if constexpr (REL) {
      skew_rows<LDP, LDK>(DSw, SKw, warp * 16 - (kTK - 1), -1);  // u = c - kl + 63
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < KD; ++j) {
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
      if constexpr (REL) {
#pragma unroll
        for (int n = 0; n < 128 / 16; ++n) {
          FragA sa;
          FragB tb;
          wmma::load_matrix_sync(sa, SKw + n * 16, LDK);
          wmma::load_matrix_sync(tb, PQs + n * 16 * LDB + j * 16, LDB);
          wmma::mma_sync(ak[j], sa, tb, ak[j]);
        }
      }
    }
  }
  const int row0 = k0 + warp * 16;
  store_rows<D, LDS>(ak, Sw, (bf16*)a.dk, tok0, row0, S, a.lddk, h * D);
  store_rows<D, LDS>(av, Sw, (bf16*)a.dv, tok0, row0, S, a.lddv, h * D);
}

// Shared-memory plan of the bf16 per-offset kernel (byte offsets).
template <int D>
struct RelWmmaPlan {
  static constexpr int LDB = D + 8, LDP = 64 + 8, LDK = 128 + 8;
  static constexpr int LDC = 128 + 4;  // f32 pitch over the 128 staged keys
  static constexpr int LDR = 64 + 4;   // f32 pitch over the 64 own offsets
  static constexpr size_t q = 0;
  static constexpr size_t g = align128(q + 2 * 64 * LDB);
  static constexpr size_t k = align128(g + 2 * 64 * LDB);
  static constexpr size_t v = align128(k + 2 * 128 * LDB);
  static constexpr size_t pk = align128(v + 2 * 128 * LDB);
  static constexpr size_t pq = align128(pk + 2 * 64 * LDB);
  static constexpr size_t sqk = align128(pq + 2 * 64 * LDB);
  static constexpr size_t dpv = align128(sqk + 4 * 64 * LDC);
  static constexpr size_t qpk = align128(dpv + 4 * 64 * LDC);
  static constexpr size_t kpq = align128(qpk + 4 * 64 * LDR);
  static constexpr size_t ds = align128(kpq + 4 * 128 * LDR);
  static constexpr size_t sk = align128(ds + 2 * 4 * 16 * LDP);
  static constexpr size_t st = align128(sk + 2 * 4 * 16 * LDK);
  static constexpr size_t bytes = align128(st + 4 * 3 * 64);
};

// bf16 per-offset table sums: for the block's 64 offsets r and each
// streamed query tile, the products Q K^T, dout V^T over the 128 keys
// q - r can reach, Q PK_r^T and K PQ_r^T run on the tensor cores; each
// (r, q) element gathers its ds from them; gc = ds Q and gp = skew(ds) K
// on the tensor cores again.
template <int D>
__global__ void __launch_bounds__(kAttnThreads) attn_bwd_rel_wmma_kernel(AttnBwdArgs a) {
  using namespace nvcuda;
  using P = RelWmmaPlan<D>;
  constexpr int LDB = P::LDB, LDP = P::LDP, LDK = P::LDK, LDC = P::LDC, LDR = P::LDR;
  constexpr int KD = D / 16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Qs = (bf16*)(smem_raw + P::q);
  bf16* DAs = (bf16*)(smem_raw + P::g);
  bf16* Ks = (bf16*)(smem_raw + P::k);    // [128] keys kbase + i
  bf16* Vs = (bf16*)(smem_raw + P::v);
  bf16* PKr = (bf16*)(smem_raw + P::pk);  // [64] table rows of the own offsets
  bf16* PQr = (bf16*)(smem_raw + P::pq);
  float* SQK = (float*)(smem_raw + P::sqk);  // [64 q][128 k]
  float* DPV = (float*)(smem_raw + P::dpv);
  float* QPK = (float*)(smem_raw + P::qpk);  // [64 q][64 r]
  float* KPQ = (float*)(smem_raw + P::kpq);  // [128 k][64 r]
  bf16* DSw = (bf16*)(smem_raw + P::ds) + warp * 16 * LDP;
  bf16* SKw = (bf16*)(smem_raw + P::sk) + warp * 16 * LDK;
  float* St = (float*)(smem_raw + P::st);

  const int h = blockIdx.y, b = blockIdx.z, S = a.f.S;
  const int r0 = (int)blockIdx.x * 64 - (S - 1);
  const int bh = b * a.f.H + h;
  const size_t tok0 = (size_t)b * S;
  const bf16* Q = (const bf16*)a.f.q;
  const bf16* K = (const bf16*)a.f.k;
  const bf16* V = (const bf16*)a.f.v;
  const bf16* DO = (const bf16*)a.dout;
  const bf16* PK = (const bf16*)a.f.pos_k;
  const bf16* PQ = (const bf16*)a.f.pos_q;
  stage_rows<D, LDB>(PKr, 64, [&](int rl) -> const bf16* {
    return r0 + rl < S ? PK + (size_t)a.f.idx_c[r0 + rl + S - 1] * a.f.ldp + h * D : nullptr;
  });
  stage_rows<D, LDB>(PQr, 64, [&](int rl) -> const bf16* {
    return r0 + rl < S ? PQ + (size_t)a.f.idx_p[r0 + rl + S - 1] * a.f.ldp + h * D : nullptr;
  });
  FragC gc[KD], gp[KD];
#pragma unroll
  for (int j = 0; j < KD; ++j) {
    wmma::fill_fragment(gc[j], 0.0f);
    wmma::fill_fragment(gp[j], 0.0f);
  }

  for (int q0 = 0; q0 < S; q0 += kTQ) {
    const int kbase = q0 - (r0 + 63);  // key of staged row 0
    if (kbase + kRelRows <= 0 || kbase >= S) continue;  // uniform over the block
    __syncthreads();
    stage_rows<D, LDB>(Qs, kTQ, [&](int r) -> const bf16* {
      return q0 + r < S ? Q + (tok0 + q0 + r) * a.f.ldq + h * D : nullptr;
    });
    stage_rows<D, LDB>(DAs, kTQ, [&](int r) -> const bf16* {
      return q0 + r < S ? DO + (tok0 + q0 + r) * a.f.lddo + h * D : nullptr;
    });
    stage_rows<D, LDB>(Ks, 128, [&](int r) -> const bf16* {
      const int kk = kbase + r;
      return r < kRelRows && kk >= 0 && kk < S ? K + (tok0 + kk) * a.f.ldk + h * D : nullptr;
    });
    stage_rows<D, LDB>(Vs, 128, [&](int r) -> const bf16* {
      const int kk = kbase + r;
      return r < kRelRows && kk >= 0 && kk < S ? V + (tok0 + kk) * a.f.ldv + h * D : nullptr;
    });
    stage_stats(a, St, bh, q0);
    __syncthreads();
    {  // this warp's 16 query rows against the 128 keys and 64 offsets,
       // and its 32 key rows against the 64 offsets
      FragA qa[KD], ga[KD];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * LDB + kk * 16, LDB);
        wmma::load_matrix_sync(ga[kk], DAs + warp * 16 * LDB + kk * 16, LDB);
      }
      FragC c;
      FragBt tb;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          wmma::load_matrix_sync(tb, Ks + n * 16 * LDB + kk * 16, LDB);
          wmma::mma_sync(c, qa[kk], tb, c);
        }
        wmma::store_matrix_sync(SQK + warp * 16 * LDC + n * 16, c, LDC, wmma::mem_row_major);
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          wmma::load_matrix_sync(tb, Vs + n * 16 * LDB + kk * 16, LDB);
          wmma::mma_sync(c, ga[kk], tb, c);
        }
        wmma::store_matrix_sync(DPV + warp * 16 * LDC + n * 16, c, LDC, wmma::mem_row_major);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::fill_fragment(c, 0.0f);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          wmma::load_matrix_sync(tb, PKr + n * 16 * LDB + kk * 16, LDB);
          wmma::mma_sync(c, qa[kk], tb, c);
        }
        wmma::store_matrix_sync(QPK + warp * 16 * LDR + n * 16, c, LDR, wmma::mem_row_major);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kr = warp * 32 + half * 16;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          wmma::load_matrix_sync(qa[kk], Ks + kr * LDB + kk * 16, LDB);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fill_fragment(c, 0.0f);
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            wmma::load_matrix_sync(tb, PQr + n * 16 * LDB + kk * 16, LDB);
            wmma::mma_sync(c, qa[kk], tb, c);
          }
          wmma::store_matrix_sync(KPQ + kr * LDR + n * 16, c, LDR, wmma::mem_row_major);
        }
      }
    }
    __syncthreads();
    // rows: this warp's 16 offsets; lanes: queries (lane, lane + 32)
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int rl = warp * 16 + r, rg = r0 + rl;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int cc = lane + 32 * jj, qg = q0 + cc, kg = qg - rg, kl = cc - rl + 63;
        float ds = 0.0f;
        if (qg < S && kg >= 0 && kg < S && rg < S) {
          const float s = SQK[cc * LDC + kl] + QPK[cc * LDR + rl] + KPQ[kl * LDR + rl];
          const bool masked = a.f.mask && a.f.mask[tok0 + kg] == 0;
          ds = ds_elem(a, s, DPV[cc * LDC + kl], St[cc], St[kTQ + cc], St[2 * kTQ + cc], bh, qg,
                       kg, masked).ds;
        }
        DSw[r * LDP + cc] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    // the same ds by key: column kl = c - rl + 63 for the warp's row rl
    skew_rows<LDP, LDK>(DSw, SKw, warp * 16 - 63, -1);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < KD; ++j) {
#pragma unroll
      for (int kk = 0; kk < kTQ / 16; ++kk) {
        FragA pa;
        FragB qb;
        wmma::load_matrix_sync(pa, DSw + kk * 16, LDP);
        wmma::load_matrix_sync(qb, Qs + kk * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(gc[j], pa, qb, gc[j]);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        FragA sa;
        FragB kb;
        wmma::load_matrix_sync(sa, SKw + n * 16, LDK);
        wmma::load_matrix_sync(kb, Ks + n * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(gp[j], sa, kb, gp[j]);
      }
    }
  }
  __syncthreads();  // SQK is free: each warp's epilogue scratch
  const int R = 2 * S - 1, row0 = r0 + (S - 1) + warp * 16;
  float* scratch = SQK + warp * 16 * LDC;
  store_rows<D, LDC>(gc, scratch, a.gc, (size_t)bh * R, row0, R, D, 0);
  store_rows<D, LDC>(gp, scratch, a.gp, (size_t)bh * R, row0, R, D, 0);
}

// -------------------------------------------- REL: per-offset table sums

template <int D>
constexpr size_t rel_smem_floats() {
  return (size_t)(2 * 64 + 2 * kRelRows + 2 * 64) * (D + 1) + 4 * 16 * 64 + 3 * 64;
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads) attn_bwd_rel_kernel(AttnBwdArgs a) {
  constexpr int LD = D + 1, DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;                   // [64] queries of the streamed tile
  float* DAs = Qs + kTQ * LD;
  float* Ks = DAs + kTQ * LD;         // [127] keys q - r of that tile
  float* Vs = Ks + kRelRows * LD;
  float* PKs = Vs + kRelRows * LD;    // [64] table rows of the own offsets
  float* PQs = PKs + 64 * LD;
  float* Ps = PQs + 64 * LD;
  float* St = Ps + 4 * 16 * kTQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z, S = a.f.S;
  const int r0 = (int)blockIdx.x * 64 - (S - 1);
  const int bh = b * a.f.H + h;
  const size_t tok0 = (size_t)b * S;
  const T* Q = (const T*)a.f.q;
  const T* K = (const T*)a.f.k;
  const T* V = (const T*)a.f.v;
  const T* DO = (const T*)a.dout;
  const T* PK = (const T*)a.f.pos_k;
  const T* PQ = (const T*)a.f.pos_q;

  stage_f32<T, D, LD>(PKs, 64, [&](int rl) -> const T* {
    const int r = r0 + rl;
    return r < S ? PK + (size_t)a.f.idx_c[r + S - 1] * a.f.ldp + h * D : nullptr;
  });
  stage_f32<T, D, LD>(PQs, 64, [&](int rl) -> const T* {
    const int r = r0 + rl;
    return r < S ? PQ + (size_t)a.f.idx_p[r + S - 1] * a.f.ldp + h * D : nullptr;
  });
  float gc[16][DPL], gp[16][DPL];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < DPL; ++j) gc[r][j] = gp[r][j] = 0.0f;
  float* P = Ps + warp * 16 * kTQ;

  for (int q0 = 0; q0 < S; q0 += kTQ) {
    const int kbase = q0 - (r0 + 63);  // key of staged row 0
    if (kbase + kRelRows <= 0 || kbase >= S) continue;  // uniform over the block
    __syncthreads();
    stage_f32<T, D, LD>(Qs, kTQ, [&](int r) -> const T* {
      return q0 + r < S ? Q + (tok0 + q0 + r) * a.f.ldq + h * D : nullptr;
    });
    stage_f32<T, D, LD>(DAs, kTQ, [&](int r) -> const T* {
      return q0 + r < S ? DO + (tok0 + q0 + r) * a.f.lddo + h * D : nullptr;
    });
    stage_f32<T, D, LD>(Ks, kRelRows, [&](int r) -> const T* {
      const int k = kbase + r;
      return k >= 0 && k < S ? K + (tok0 + k) * a.f.ldk + h * D : nullptr;
    });
    stage_f32<T, D, LD>(Vs, kRelRows, [&](int r) -> const T* {
      const int k = kbase + r;
      return k >= 0 && k < S ? V + (tok0 + k) * a.f.ldv + h * D : nullptr;
    });
    stage_stats(a, St, bh, q0);
    __syncthreads();

    // rows: this warp's 16 offsets; lanes: queries (lane, lane + 32)
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
      const int rl = warp * 16 + r, rg = r0 + rl;
      const float* pk = PKs + rl * LD;
      const float* pq = PQs + rl * LD;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, qg = q0 + c, kg = qg - rg, kl = c - rl + 63;
        float ds = 0.0f;
        if (qg < S && kg >= 0 && kg < S && rg < S) {
          const float* qr = Qs + c * LD;
          const float* kr = Ks + kl * LD;
          const float* gr = DAs + c * LD;
          const float* vr = Vs + kl * LD;
          float s = 0.0f, dp = 0.0f;
          for (int d = 0; d < D; ++d) {
            s = fmaf(qr[d], kr[d] + pk[d], fmaf(kr[d], pq[d], s));
            dp = fmaf(gr[d], vr[d], dp);
          }
          const bool masked = a.f.mask && a.f.mask[tok0 + kg] == 0;
          ds = ds_elem(a, s, dp, St[c], St[kTQ + c], St[2 * kTQ + c], bh, qg, kg, masked).ds;
        }
        P[r * kTQ + c] = ds;
      }
    }
    __syncwarp();
    for (int c = 0; c < kTQ; ++c) {
      float qv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        qv[j] = d < D ? Qs[c * LD + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float ds = P[r * kTQ + c];
        const int kl = c - (warp * 16 + r) + 63;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          gc[r][j] = fmaf(ds, qv[j], gc[r][j]);
          if (d < D) gp[r][j] = fmaf(ds, Ks[kl * LD + d], gp[r][j]);
        }
      }
    }
    __syncwarp();
  }
  const int R = 2 * S - 1;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int rg = r0 + warp * 16 + r;
    if (rg >= S) continue;
    const size_t row = ((size_t)bh * R + rg + S - 1) * D;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        a.gc[row + d] = gc[r][j];
        a.gp[row + d] = gp[r][j];
      }
    }
  }
}

// out[t, h*D + d] = sum_b sum_{i in [off[t], off[t+1])} g[b, h, order[i], d]:
// the per-offset rows folded into table rows, in a fixed order.
static __global__ void fold_kernel(const float* __restrict__ g, const int* __restrict__ order,
                                   const int* __restrict__ off, int rows, int B, int H, int R,
                                   int D, float* __restrict__ out) {
  const int HD = H * D;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * HD) return;
  const int t = i / HD, h = (i % HD) / D, d = i % D;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* gb = g + ((size_t)(b * H + h) * R) * D + d;
    for (int e = off[t]; e < off[t + 1]; ++e) s += gb[(size_t)order[e] * D];
  }
  out[i] = s;
}

template <typename Kern>
static inline int launch_smem(Kern k, dim3 grid, size_t bytes, const AttnBwdArgs& a,
                              cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, kAttnThreads, bytes, st>>>(a);
  SMM_CHECK_LAUNCH();
  return 0;
}

template <typename T, int D, bool REL>
static inline int launch_attention_bwd_d(const AttnBwdArgs& a, int B, cudaStream_t st) {
  const int S = a.f.S, H = a.f.H;
  const dim3 tiles((S + 63) / 64, H, B);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t bytes = BwdWmmaPlan<D, REL>::bytes;
    if (int e = launch_smem(attn_bwd_dq_wmma_kernel<D, REL>, tiles, bytes, a, st)) return e;
    if (int e = launch_smem(attn_bwd_dkv_wmma_kernel<D, REL>, tiles, bytes, a, st)) return e;
    if constexpr (REL) {
      const dim3 offs((2 * S - 1 + 63) / 64, H, B);
      return launch_smem(attn_bwd_rel_wmma_kernel<D>, offs, RelWmmaPlan<D>::bytes, a, st);
    }
    return 0;
  } else {
    if (int e = launch_smem(attn_bwd_dq_kernel<T, D, REL>, tiles,
                            sizeof(float) * bwd_smem_floats<D>(REL, 1), a, st))
      return e;
    if (int e = launch_smem(attn_bwd_dkv_kernel<T, D, REL>, tiles,
                            sizeof(float) * bwd_smem_floats<D>(REL, 2), a, st))
      return e;
    if constexpr (REL) {
      const dim3 offs((2 * S - 1 + 63) / 64, H, B);
      return launch_smem(attn_bwd_rel_kernel<T, D>, offs, sizeof(float) * rel_smem_floats<D>(),
                         a, st);
    }
    return 0;
  }
}

// dq/dk/dv (and with REL gc/gp) from dout and the stats of the re-run
// forward; the caller folds gc/gp.
template <typename T, bool REL>
static inline int launch_attention_bwd(const AttnBwdArgs& a, int B, int D, cudaStream_t st) {
  constexpr bool is_bf16 = std::is_same<T, bf16>::value;
  switch (D) {
    case 16: return launch_attention_bwd_d<T, 16, REL>(a, B, st);
    case 32: return launch_attention_bwd_d<T, 32, REL>(a, B, st);
    case 64:
      if constexpr (attention_wgmma_takes(is_bf16, 64, REL))
        return (int)cudaErrorInvalidValue;
      else return launch_attention_bwd_d<T, 64, REL>(a, B, st);
    case 128:  // the two staged position tables do not fit next to D = 128
      if constexpr (REL || attention_wgmma_takes(is_bf16, 128, REL))
        return (int)cudaErrorInvalidValue;
      else return launch_attention_bwd_d<T, 128, false>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace smm
