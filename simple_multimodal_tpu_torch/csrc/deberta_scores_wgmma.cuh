// DeBERTa's relative-position score terms in the wgmma accumulator layout,
// shared by the kernels that form disentangled-attention scores on wgmma
// (deberta_attention_fwd_wgmma.cu, deberta_attention_bwd_dq_wgmma.cu,
// deberta_attention_bwd_dkv_wgmma.cu):
//
//   s[q, k] = scale (q_q . k_k + q_q . pos_k[idx_c(q - k)] + k_k . pos_q[idx_p(q - k)])
//
// The design, for this card (bf16, head width 64, tiles of 64 queries x 64
// keys, one consumer warpgroup a block):
// - A tile pair (queries from q0, keys from k0) reaches the 127 offsets
//   q - k = rel0 + u, rel0 = q0 - k0 - 63, u = (q - q0) - (k - k0) + 63. The
//   producer warps stage, for each u, the table row that offset maps to
//   (pos_k[idx_c(rel0 + u)], pos_q[idx_p(rel0 + u)]; zeros past the 127 rows
//   and past |q - k| < S) as a [128][64] bf16 tile in the swizzled layout a
//   TMA copy would give it, so the index maps are read once per staged row
//   and never per score. Neighbouring offsets often share a table row (the
//   log buckets); staging one row per offset keeps the element's address a
//   matter of arithmetic and makes no assumption on the bucket map.
// - The two table products run on wgmma with N = 128: Cq = Q_tile . PKg^T
//   ([query][u]) and Ck = K_tile . PQg^T ([key][u]), f32, written from the
//   accumulators to shared memory (pitch kLdc). The element (q, k) of the
//   q.k^T accumulator then adds Cq[q][u] + Ck[k][u]: two shared-memory loads
//   at addresses formed from the thread's own (row, column).
// - The gather's transposes (the backward): ds scattered back onto (row, u)
//   is the A operand of the table terms of dq and dk,
//   dq += ds_c . PKg with ds_c[q][u] = ds[q][k], dk += ds_p . PQg with
//   ds_p[k][u] = ds[q][k]; scattered onto (u, row) it is the A operand of the
//   per-offset sums g[u] = sum ds . (Q or K rows). Every thread stores its
//   own accumulator elements (bf16) at swizzled addresses; each (row, u)
//   holds one element, at the same place for every tile pair, so the tiles
//   are zeroed once and then only overwritten.
#pragma once

#include "flash_attention_wgmma.cuh"

namespace smm {
namespace debw {

using namespace flashw;

constexpr int kD = 64;        // head width
constexpr int kTile = 64;     // queries and keys per tile
constexpr int kU = 128;       // staged table rows: the 127 offsets of a tile pair, padded
constexpr int kLdc = kU + 4;  // f32 pitch of a table product in shared memory
constexpr int kStagesRel = 2;
constexpr int kConsumerWarps = 4;
// One consumer warpgroup and four producer warps: staging the tables is a
// gather of 2 x 127 rows of 128 bytes per tile pair, bound by the latency of
// its loads; one warp doing it alone held the consumers back (0.73 ms a
// kernel against 0.40 with the staging taken out), so each producer warp
// stages 64 rows of one table with all its loads in flight.
constexpr int kProducerWarps = 4;
constexpr int kThreads = (kConsumerWarps + kProducerWarps) * 32;

constexpr int kTileBytes = tile_bytes<kD, kTile>();  // a [64][64] bf16 operand tile
constexpr int kTableBytes = kU * kD * 2;             // a staged [128][64] table
constexpr int kSkewBytes = kTile * kU * 2;           // ds on (row, u) or on (u, row)
constexpr int kProductBytes = kTile * kLdc * 4;      // a table product, f32

// Arguments of the two backward kernels. q, k, v, dout and dq, dk, dv are
// [B, S, H, 64] with `ld` elements per token; the tables [rows, ldp] with
// head h at column 64 h; m, l, delta [B, H, S] from the re-run forward.
struct RelBwdArgs {
  const bf16* pos_k;
  const bf16* pos_q;
  int ldp;
  const int* idx_c;  // [2S - 1], indexed by (q - k) + S - 1
  const int* idx_p;
  const int* mask;   // [B, S], 0 = masked key; null = none
  int S, H;
  float scale;
  Drop drop;
  const float* m;
  const float* l;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long ld;
  float* gc_part;  // [B, H, T, T + 1, 64, 64]: per query tile, blocks of 64 offsets
  float* gp_part;  // the same per key tile
};

// Arguments of the forward kernel (the backward's re-run): the context
// [B, S, H, 64] with `ld` elements per token and the row statistics [B, H, S].
struct RelFwdArgs {
  const bf16* pos_k;
  const bf16* pos_q;
  int ldp;
  const int* idx_c;
  const int* idx_p;
  const int* mask;
  int S, H;
  float scale;
  Drop drop;
  void* out;
  long long ld;
  float* m;  // row maximum of the scaled, masked scores, or null (with l: not stored)
  float* l;  // sum of exp(s - m), before the dropout
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma and TMA (the
// asynchronous proxy); a barrier or an mbarrier arrival follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (row, col) in a bf16 operand tile of ROWS rows and
// 32-column atom blocks with the 64-byte swizzle (the layout load_tile and
// the descriptors of flash_attention_wgmma.cuh use).
template <int ROWS>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return (col >> 5) * (ROWS * kSw) + hp::swizzle_offset<kSw>(row * kSw + (col & 31) * 2);
}

// One producer warp: rows u0 .. u0 + 63 of the [128][64] tile of table rows
// for the offsets rel0 + u, u = 0 .. 126 (zero rows elsewhere). The 64
// offsets' table rows are read first, two per lane; then the rows go over in
// 16-byte chunks, eight lanes a row, sixteen independent loads a lane.
__device__ __forceinline__ void stage_table_rows(unsigned char* dst, const bf16* table, int ldp,
                                                 const int* idx, int rel0, int u0, int S, int h,
                                                 int lane) {
  int t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = u0 + 32 * i + lane, rel = rel0 + u;
    t[i] = u < 2 * kTile - 1 && rel > -S && rel < S ? __ldg(idx + rel + S - 1) : -1;
  }
  const int c = lane & 7;
  uint4 v[16];
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int row = __shfl_sync(0xffffffffu, t[it >> 3], (it * 4 + (lane >> 3)) & 31);
    v[it] = make_uint4(0, 0, 0, 0);
    if (row >= 0)
      v[it] = __ldg(reinterpret_cast<const uint4*>(table + (size_t)row * ldp + h * kD) + c);
  }
#pragma unroll
  for (int it = 0; it < 16; ++it)
    *reinterpret_cast<uint4*>(dst + tile_offset<kU>(u0 + it * 4 + (lane >> 3), c * 8)) = v[it];
}

// Producer warp `p` of the four: its quarter of the two staged tables.
__device__ __forceinline__ void stage_tables(unsigned char* pk_dst, unsigned char* pq_dst,
                                             const bf16* pos_k, const bf16* pos_q, int ldp,
                                             const int* idx_c, const int* idx_p, int rel0,
                                             int S, int h, int p, int lane) {
  const int u0 = (p & 1) * kTile;
  if (p < 2) stage_table_rows(pk_dst, pos_k, ldp, idx_c, rel0, u0, S, h, lane);
  else stage_table_rows(pq_dst, pos_q, ldp, idx_p, rel0, u0, S, h, lane);
}

// A table product's accumulator (m64n128: 64 registers) to shared memory.
__device__ __forceinline__ void store_product(float* C, const float (&acc)[kU / 2],
                                              const Lane& ln) {
#pragma unroll
  for (int j = 0; j < kU / 8; ++j) {
    *reinterpret_cast<float2*>(C + ln.r * kLdc + 8 * j + ln.c) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(C + (ln.r + 8) * kLdc + 8 * j + ln.c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// One bf16 element of a skewed ds tile.
__device__ __forceinline__ void store_bf16(unsigned char* tile, uint32_t offset, float v) {
  *reinterpret_cast<bf16*>(tile + offset) = __float2bfloat16(v);
}

// Zeroes `bytes` (a multiple of 16) of shared memory with the whole block.
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// A 64 x 64 f32 accumulator to block `blk` of a per-tile partial
// ([T + 1][64][64]): rows = offsets, columns = d.
__device__ __forceinline__ void store_partial(float* part, int blk, const float (&acc)[kD / 2],
                                              const Lane& ln) {
  float* dst = part + (size_t)blk * kTile * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    *reinterpret_cast<float2*>(dst + ln.r * kD + 8 * j + ln.c) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(dst + (ln.r + 8) * kD + 8 * j + ln.c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// acc (+)= A . B with A a 64-row slice (from `row_a`) of a K-major bf16 tile
// in shared memory (RA rows tall, contraction over its KA columns) and B the
// RB rows of tile `tb` MN-major (contraction over its rows, N = 64).
template <int RA, int KA, int RB>
__device__ __forceinline__ void mma_smem_over_rows(float (&acc)[kD / 2], uint32_t ta, int row_a,
                                                   uint32_t tb, bool accumulate) {
  static_assert(KA == RB, "the contraction runs over A's columns and B's rows");
#pragma unroll
  for (int kk = 0; kk < KA / 16; ++kk)
    hp::wgmma_ss<kD, 1>(acc, desc_over_d<RA>(ta, row_a, kk), desc_over_rows<RB>(tb, kk),
                        accumulate || kk > 0);
}

// The launchers (one per source file); each returns the first CUDA error or 0.
int deberta_bwd_dq_wgmma_launch(const void* q, const void* k, const void* v, const void* dout,
                                const RelBwdArgs& a, int B, cudaStream_t st);
int deberta_bwd_dkv_wgmma_launch(const void* q, const void* k, const void* v, const void* dout,
                                 const RelBwdArgs& a, int B, cudaStream_t st);
int deberta_fwd_wgmma_launch(const void* q, const void* k, const void* v, const RelFwdArgs& a,
                             int B, cudaStream_t st);
int deberta_bwd_dq_wgmma_smem();
int deberta_bwd_dkv_wgmma_smem();
int deberta_fwd_wgmma_smem();

}  // namespace debw
}  // namespace smm
