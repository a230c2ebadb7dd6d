// Attention core shared by attention_block.cu and deberta_attention.cu:
// softmax(s) . V for one (query tile, head, batch) per block, streaming key
// and value tiles through shared memory with an online softmax, so no
// [S, S] score tensor ever reaches device memory.
//
//   s[q, k] = scale * (q_q . k_k)                                  (plain)
//   s[q, k] = scale * (q_q . k_k + q_q . pos_k[idx_c(q - k)]
//                                + k_k . pos_q[idx_p(q - k)])       (REL)
//
// REL is DeBERTa's disentangled attention: the two relative-position terms
// are direct gathers from the bucketed position tables. A (query tile, key
// tile) pair reaches at most kTQ + kTK - 1 relative offsets, so only those
// table rows are staged in shared memory. Keys past S get -inf (weight 0);
// masked keys get kMaskFill (finite), so a fully masked row attends
// uniformly over its S keys, as the TPU kernel does.
//
// q/k/v rows are read in [B, S, H, D] straight from their producers via a
// per-token row stride (3E for the packed projection buffer), so no
// transposed copies are made.
//
// Dropout (attention_block, deberta_attention in training): probabilities
// are normalised by the row sum of ALL exponentials, pre-dropout, and each
// kept one is scaled by 1/(1-rate) before its bf16 rounding and .V, as the
// TPU kernel's `_kernel` does; the keep mask is the stateless hash of
// (seed, b*H + h, q, k) (common.cuh).
//
// The backward (attention_bwd.cuh) re-runs this kernel with `m_out`,
// `l_out` and `delta` set: it then also stores each row's max and sum of
// exponentials, and delta = rowsum(dout * out) per head, the softmax
// backward's row term (sum_k dp p, which equals dout . ctx with dropout).
//
// Two bodies: for bf16, `attention_wmma_kernel` runs every product (QK^T,
// P.V and, with REL, the two query/key x table-row products) on the tensor
// cores through WMMA with f32 accumulators, the probabilities rounded to
// bf16 before P.V as the reference rounds them; for f32, `attention_kernel`
// runs the same algorithm as plain f32 FMA on the CUDA cores, so f32 calls
// stay exact. The online softmax is f32 in both.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace smm {

constexpr int kTQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int kTK = 64;  // keys per streamed tile
constexpr int kRelRows = kTQ + kTK - 1;
constexpr int kAttnThreads = 128;

// Which body an attention core of these blocks takes (attention_block's:
// rel = false; deberta_attention's: rel = true): true = the wgmma kernels
// (the backwards: attention_core_bwd_wgmma.cu, deberta_attention_bwd_{dq,
// dkv}_wgmma.cu; deberta_attention's forward: deberta_attention_fwd_wgmma.cu),
// false = attention_bwd.cuh's backwards and this file's forward. One rule,
// forward and backward, from the element type and the head width alone: bf16 at D = 64, and at 128 without the position tables. (At these
// widths a token's row is a multiple of 64 elements, so the tensor maps'
// 16-byte strides hold; the wrappers see to 16-byte aligned bases.) The bf16
// bodies of attention_bwd.cuh, and this file's bf16 body with the position
// tables at D = 64, are therefore not instantiated at those widths.
constexpr bool attention_wgmma_takes(bool is_bf16, int D, bool rel) {
  return is_bf16 && (D == 64 || (D == 128 && !rel));
}

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  int ldq, ldk, ldv;  // elements between consecutive tokens
  void* out;
  int ldo;
  int S, H;
  float scale;
  // REL only
  const void* pos_k;  // [2 * span, ldp]: head h at column h * D
  const void* pos_q;
  int ldp;
  const int* idx_c;  // [2S - 1], indexed by (q - k) + S - 1
  const int* idx_p;
  const int* mask;  // [B, S], 0 = masked key; null = none
  Drop drop;
  // backward re-run only: row stats [B*H*S] and delta from dout [.., lddo]
  float* m_out;
  float* l_out;
  float* delta;
  const void* dout;
  int lddo;
};

// The probability that goes into P.V: dropped or scaled by the hash.
__device__ __forceinline__ float drop_prob(const AttnArgs& a, float p, int bh, int q, int k) {
  if (!a.drop.seed) return p;
  return hash_keep((uint32_t)*a.drop.seed, bh, q, k, a.drop.thresh) ? p * a.drop.scale : 0.0f;
}

// End of a query row: the row stats and delta for the backward. `o` holds
// this lane's output columns lane + 32 j, already divided by l.
template <typename T, int DPL, int D>
__device__ __forceinline__ void store_row_stats(const AttnArgs& a, size_t tok, int h, size_t bhs,
                                                float m, float l, const float (&o)[DPL]) {
  const int lane = threadIdx.x & 31;
  if (a.m_out && lane == 0) {
    a.m_out[bhs] = m;
    a.l_out[bhs] = l;
  }
  if (a.delta) {
    const T* dO = (const T*)a.dout + tok * a.lddo + h * D;
    float d = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int c = lane + 32 * j;
      if (c < D) d += o[j] * to_f32(dO[c]);
    }
    d = warp_sum(d);
    if (lane == 0) a.delta[bhs] = d;
  }
}

template <int D, bool REL>
constexpr size_t attention_smem_bytes() {
  return sizeof(float) * ((size_t)(kTQ + 2 * kTK) * (D + 1) + 4 * 16 * kTK +
                          (REL ? 2 * (size_t)kRelRows * (D + 1) : 0));
}

// TRAIN: the dropout and the backward's row statistics are compiled in
// (serving instantiates the kernels without them).
template <typename T, int D, bool REL, bool TRAIN>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(AttnArgs a) {
  constexpr int LD = D + 1;  // odd pitch: lanes reading different rows hit different banks
  constexpr int DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTQ * LD;
  float* Vs = Ks + kTK * LD;
  float* Ps = Vs + kTK * LD;  // [4 warps][16][kTK]
  float* PKs = Ps + 4 * 16 * kTK;
  float* PQs = PKs + kRelRows * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const T* Q = (const T*)a.q;
  const T* K = (const T*)a.k;
  const T* V = (const T*)a.v;
  const size_t tok0 = (size_t)b * S;

  for (int e = tid; e < kTQ * D; e += kAttnThreads) {
    const int r = e / D, d = e % D, s = q0 + r;
    Qs[r * LD + d] = s < S ? to_f32(Q[(tok0 + s) * a.ldq + h * D + d]) : 0.0f;
  }

  float m[16], l[16], o[16][DPL];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[r][j] = 0.0f;
  }
  float* P = Ps + warp * 16 * kTK;
  const float* Qw = Qs + warp * 16 * LD;

  for (int k0 = 0; k0 < S; k0 += kTK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kTK * D; e += kAttnThreads) {
      const int r = e / D, d = e % D, s = k0 + r;
      const bool ok = s < S;
      Ks[r * LD + d] = ok ? to_f32(K[(tok0 + s) * a.ldk + h * D + d]) : 0.0f;
      Vs[r * LD + d] = ok ? to_f32(V[(tok0 + s) * a.ldv + h * D + d]) : 0.0f;
    }
    if (REL) {
      const T* PK = (const T*)a.pos_k;
      const T* PQ = (const T*)a.pos_q;
      const int rel0 = q0 - k0 - (kTK - 1);  // relative offset of table row 0
      for (int e = tid; e < kRelRows * D; e += kAttnThreads) {
        const int u = e / D, d = e % D, rel = rel0 + u;
        const bool ok = rel > -S && rel < S;
        PKs[u * LD + d] = ok ? to_f32(PK[(size_t)a.idx_c[rel + S - 1] * a.ldp + h * D + d]) : 0.0f;
        PQs[u * LD + d] = ok ? to_f32(PQ[(size_t)a.idx_p[rel + S - 1] * a.ldp + h * D + d]) : 0.0f;
      }
    }
    __syncthreads();

    // scores for this warp's 16 rows x keys (lane, lane + 32)
    float sc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) sc[r][0] = sc[r][1] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * LD + d], kb = Ks[(lane + 32) * LD + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = Qw[r * LD + d];
        sc[r][0] = fmaf(qv, ka, sc[r][0]);
        sc[r][1] = fmaf(qv, kb, sc[r][1]);
      }
    }
    if (REL) {
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = lane + 32 * j;
          const int u = warp * 16 + r - c + (kTK - 1);  // row of (q - k) in the staged tables
          const float* qr = Qw + r * LD;
          const float* kr = Ks + c * LD;
          const float* pk = PKs + u * LD;
          const float* pq = PQs + u * LD;
          float acc = 0.0f;
          for (int d = 0; d < D; ++d) acc = fmaf(qr[d], pk[d], fmaf(kr[d], pq[d], acc));
          sc[r][j] += acc;
        }
    }

    // online softmax over the tile, one row at a time across the warp
    bool past_end[2], masked[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kg = k0 + lane + 32 * j;
      past_end[j] = kg >= S;
      masked[j] = REL && a.mask && !past_end[j] && a.mask[tok0 + kg] == 0;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float s2[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s2[j] = past_end[j] ? -INFINITY : masked[j] ? kMaskFill : sc[r][j] * a.scale;
      const float mnew = fmaxf(m[r], warp_max(fmaxf(s2[0], s2[1])));
      const float alpha = __expf(m[r] - mnew);
      float p0 = __expf(s2[0] - mnew), p1 = __expf(s2[1] - mnew);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = mnew;
#pragma unroll
      for (int j = 0; j < DPL; ++j) o[r][j] *= alpha;
      if (TRAIN) {
        const int bh = b * a.H + h, qg = q0 + warp * 16 + r;
        p0 = drop_prob(a, p0, bh, qg, k0 + lane);
        p1 = drop_prob(a, p1, bh, qg, k0 + lane + 32);
      }
      P[r * kTK + lane] = p0;
      P[r * kTK + lane + 32] = p1;
    }
    __syncwarp();

    // o += P . V, this lane's output columns lane + 32 j
    for (int kk = 0; kk < kTK; ++kk) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < D ? Vs[kk * LD + c] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = P[r * kTK + kk];
#pragma unroll
        for (int j = 0; j < DPL; ++j) o[r][j] = fmaf(p, vv[j], o[r][j]);
      }
    }
    __syncwarp();
  }

  T* O = (T*)a.out;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + warp * 16 + r;
    if (s >= S) continue;
    const float inv = 1.0f / l[r];
    float on[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int c = lane + 32 * j;
      on[j] = o[r][j] * inv;
      if (c < D) O[(tok0 + s) * a.ldo + h * D + c] = from_f32<T>(on[j]);
    }
    if (TRAIN)
      store_row_stats<T, DPL, D>(a, tok0 + s, h, ((size_t)b * a.H + h) * S + s, m[r], l[r], on);
  }
}

// ------------------------------------------------------- bf16 tensor cores

constexpr size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

// Shared-memory plan of the WMMA body (byte offsets, 128-aligned).
template <int D, bool REL>
struct WmmaPlan {
  static constexpr int LDB = D + 8;                     // bf16 pitch: Q, K, V, table rows
  static constexpr int LDS = (D > kTK ? D : kTK) + 4;   // f32 pitch: a warp's scores / P.V
  static constexpr int LDP = kTK + 8;                   // bf16 pitch: a warp's P
  static constexpr int kTabRows = 128;                  // kRelRows staged, padded to 16s
  static constexpr int LDC = kTabRows + 4;              // f32 pitch: the table products
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + 2 * kTQ * LDB);
  static constexpr size_t v = align128(k + 2 * kTK * LDB);
  static constexpr size_t s = align128(v + 2 * kTK * LDB);
  static constexpr size_t p = align128(s + 4 * 4 * 16 * LDS);
  static constexpr size_t pk = align128(p + 2 * 4 * 16 * LDP);
  static constexpr size_t pq = align128(pk + (REL ? 2 * kTabRows * LDB : 0));
  static constexpr size_t c = align128(pq + (REL ? 2 * kTabRows * LDB : 0));
  static constexpr size_t dk = align128(c + (REL ? 4 * 4 * 16 * LDC : 0));
  static constexpr size_t bytes = align128(dk + (REL ? 4 * kTK * LDC : 0));
};

// Copies `rows` rows of D bf16 values (16-byte chunks) into a pitch-LDB tile;
// row r comes from src_row(r), or is zero when that returns null.
template <int D, int LDB, typename RowFn>
__device__ __forceinline__ void stage_rows(bf16* dst, int rows, RowFn src_row) {
  constexpr int CPR = D / 8;
  for (int e = threadIdx.x; e < rows * CPR; e += kAttnThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bf16* src = src_row(r);
    *(uint4*)(dst + r * LDB + c) = src ? *(const uint4*)(src + c) : make_uint4(0, 0, 0, 0);
  }
}

template <int D, bool REL, bool TRAIN>
__global__ void __launch_bounds__(kAttnThreads) attention_wmma_kernel(AttnArgs a) {
  using namespace nvcuda;
  using P = WmmaPlan<D, REL>;
  constexpr int LDB = P::LDB, LDS = P::LDS, LDP = P::LDP, LDC = P::LDC;
  constexpr int DPL = (D + 31) / 32, KD = D / 16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Qs = (bf16*)(smem_raw + P::q);
  bf16* Ks = (bf16*)(smem_raw + P::k);
  bf16* Vs = (bf16*)(smem_raw + P::v);
  float* Sw = (float*)(smem_raw + P::s) + warp * 16 * LDS;
  bf16* Pw = (bf16*)(smem_raw + P::p) + warp * 16 * LDP;
  bf16* PKs = (bf16*)(smem_raw + P::pk);
  bf16* PQs = (bf16*)(smem_raw + P::pq);
  float* Cw = (float*)(smem_raw + P::c) + warp * 16 * LDC;  // q_r . PK[u], this warp's rows
  float* Dk = (float*)(smem_raw + P::dk);                   // k_c . PQ[u], every key row

  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S;
  const bf16* Q = (const bf16*)a.q;
  const bf16* K = (const bf16*)a.k;
  const bf16* V = (const bf16*)a.v;
  const size_t tok0 = (size_t)b * S;

  stage_rows<D, LDB>(Qs, kTQ, [&](int r) -> const bf16* {
    return q0 + r < S ? Q + (tok0 + q0 + r) * a.ldq + h * D : nullptr;
  });
  __syncthreads();
  FragA qf[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LDB + kk * 16, LDB);

  float m[16], l[16], o[16][DPL];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[r][j] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += kTK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D, LDB>(Ks, kTK, [&](int r) -> const bf16* {
      return k0 + r < S ? K + (tok0 + k0 + r) * a.ldk + h * D : nullptr;
    });
    stage_rows<D, LDB>(Vs, kTK, [&](int r) -> const bf16* {
      return k0 + r < S ? V + (tok0 + k0 + r) * a.ldv + h * D : nullptr;
    });
    if (REL) {
      const int rel0 = q0 - k0 - (kTK - 1);  // relative offset of table row 0
      const bf16* PK = (const bf16*)a.pos_k;
      const bf16* PQ = (const bf16*)a.pos_q;
      auto ok = [&](int u) { return u < kRelRows && rel0 + u > -S && rel0 + u < S; };
      stage_rows<D, LDB>(PKs, P::kTabRows, [&](int u) -> const bf16* {
        return ok(u) ? PK + (size_t)a.idx_c[rel0 + u + S - 1] * a.ldp + h * D : nullptr;
      });
      stage_rows<D, LDB>(PQs, P::kTabRows, [&](int u) -> const bf16* {
        return ok(u) ? PQ + (size_t)a.idx_p[rel0 + u + S - 1] * a.ldp + h * D : nullptr;
      });
    }
    __syncthreads();

    FragC acc;
#pragma unroll
    for (int j = 0; j < kTK / 16; ++j) {  // scores: 16 rows x 64 keys
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        FragBt kb;
        wmma::load_matrix_sync(kb, Ks + j * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(acc, qf[kk], kb, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, LDS, wmma::mem_row_major);
    }
    if (REL) {
      FragA kf[KD];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        wmma::load_matrix_sync(kf[kk], Ks + warp * 16 * LDB + kk * 16, LDB);
#pragma unroll
      for (int n = 0; n < P::kTabRows / 16; ++n) {
        FragBt tb;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          wmma::load_matrix_sync(tb, PKs + n * 16 * LDB + kk * 16, LDB);
          wmma::mma_sync(acc, qf[kk], tb, acc);
        }
        wmma::store_matrix_sync(Cw + n * 16, acc, LDC, wmma::mem_row_major);
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          wmma::load_matrix_sync(tb, PQs + n * 16 * LDB + kk * 16, LDB);
          wmma::mma_sync(acc, kf[kk], tb, acc);
        }
        wmma::store_matrix_sync(Dk + warp * 16 * LDC + n * 16, acc, LDC, wmma::mem_row_major);
      }
      __syncthreads();  // every warp's key rows of Dk
    } else {
      __syncwarp();
    }

    // online softmax over the tile, one row at a time across the warp
    bool past_end[2], masked[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kg = k0 + lane + 32 * j;
      past_end[j] = kg >= S;
      masked[j] = REL && a.mask && !past_end[j] && a.mask[tok0 + kg] == 0;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float s2[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        float s = Sw[r * LDS + c];
        if (REL) {
          const int u = warp * 16 + r - c + (kTK - 1);  // row of (q - k) in the staged tables
          s += Cw[r * LDC + u] + Dk[c * LDC + u];
        }
        s2[j] = past_end[j] ? -INFINITY : masked[j] ? kMaskFill : s * a.scale;
      }
      const float mnew = fmaxf(m[r], warp_max(fmaxf(s2[0], s2[1])));
      const float alpha = __expf(m[r] - mnew);
      float p0 = __expf(s2[0] - mnew), p1 = __expf(s2[1] - mnew);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = mnew;
#pragma unroll
      for (int j = 0; j < DPL; ++j) o[r][j] *= alpha;
      if (TRAIN) {
        const int bh = b * a.H + h, qg = q0 + warp * 16 + r;
        p0 = drop_prob(a, p0, bh, qg, k0 + lane);
        p1 = drop_prob(a, p1, bh, qg, k0 + lane + 32);
      }
      Pw[r * LDP + lane] = __float2bfloat16(p0);
      Pw[r * LDP + lane + 32] = __float2bfloat16(p1);
    }
    __syncwarp();

    // o += P . V: 16 rows x D, through the scores scratch
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        FragA pa;
        FragB vb;
        wmma::load_matrix_sync(pa, Pw + kk * 16, LDP);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int c = lane + 32 * j;
        if (c < D) o[r][j] += Sw[r * LDS + c];
      }
  }

  bf16* O = (bf16*)a.out;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + warp * 16 + r;
    if (s >= S) continue;
    const float inv = 1.0f / l[r];
    float on[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int c = lane + 32 * j;
      on[j] = o[r][j] * inv;
      if (c < D) O[(tok0 + s) * a.ldo + h * D + c] = __float2bfloat16(on[j]);
    }
    if (TRAIN)
      store_row_stats<bf16, DPL, D>(a, tok0 + s, h, ((size_t)b * a.H + h) * S + s, m[r], l[r],
                                    on);
  }
}

template <typename T, int D, bool REL, bool TRAIN>
static inline int launch_attention_t(const AttnArgs& a, int B, cudaStream_t st) {
  dim3 grid((a.S + kTQ - 1) / kTQ, a.H, B);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = WmmaPlan<D, REL>::bytes;
    const cudaError_t e = cudaFuncSetAttribute(attention_wmma_kernel<D, REL, TRAIN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_wmma_kernel<D, REL, TRAIN><<<grid, kAttnThreads, smem, st>>>(a);
  } else {
    constexpr size_t smem = attention_smem_bytes<D, REL>();
    const cudaError_t e = cudaFuncSetAttribute(attention_kernel<T, D, REL, TRAIN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    attention_kernel<T, D, REL, TRAIN><<<grid, kAttnThreads, smem, st>>>(a);
  }
  SMM_CHECK_LAUNCH();
  return 0;
}

template <typename T, int D, bool REL>
static inline int launch_attention_d(const AttnArgs& a, int B, cudaStream_t st) {
  if (a.drop.seed || a.m_out) return launch_attention_t<T, D, REL, true>(a, B, st);
  return launch_attention_t<T, D, REL, false>(a, B, st);
}

// Head widths the kernel is instantiated for; the wrappers check D first.
template <typename T, bool REL>
static inline int launch_attention(const AttnArgs& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch_attention_d<T, 16, REL>(a, B, st);
    case 32: return launch_attention_d<T, 32, REL>(a, B, st);
    case 64:  // deberta_attention's bf16 core at 64 is deberta_attention_fwd_wgmma.cu
      if constexpr (attention_wgmma_takes(std::is_same<T, bf16>::value, 64, REL) && REL)
        return (int)cudaErrorInvalidValue;
      else return launch_attention_d<T, 64, REL>(a, B, st);
    case 128:  // the two staged position tables do not fit next to D = 128
      if constexpr (REL) return (int)cudaErrorInvalidValue;
      else return launch_attention_d<T, 128, false>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace smm
