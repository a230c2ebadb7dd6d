// What the three wgmma flash-attention kernels share (bf16, head widths 64,
// 96 and 128): flash_attention_wgmma.cu (forward),
// flash_attention_bwd_dq_wgmma.cu and flash_attention_bwd_dkv_wgmma.cu.
//
// The design, for this card:
// - Every product is a warpgroup `wgmma.mma_async` (csrc/hopper.cuh). One
//   warpgroup owns 64 rows of the output (queries; keys in the dk/dv
//   kernel) and keeps its sums (O; dq; dk and dv) in accumulator registers
//   from the first streamed tile to the store.
// - Scores never touch shared memory: the softmax, the probabilities and
//   dS are computed in the accumulator's own register layout (a row lives
//   in four neighbouring lanes: a row maximum or sum is two shuffles), and
//   rounded to bf16 they are the A registers of the next product (P.V;
//   dS.K; P^T.dO and dS^T.Q).
// - Tiles are copied by TMA. A [rows][D] tile of a [B, S, H, D] tensor is
//   D/32 boxes of 32 columns (64 bytes: the 64-byte swizzle, which fits
//   every width here; 96 columns are no whole number of 128-byte atoms),
//   read in place through the tensor's batch and token strides; rows past
//   the tensor's end arrive as zeros and are masked in registers. The same
//   tile serves as a K-major operand (contraction over d: q.k^T, dout.v^T)
//   and as an MN-major one (contraction over tokens: p.v, ds.k, p^T.dout,
//   ds^T.q) through the two descriptor forms of hopper.cuh.
// - Streamed tiles go through a ring of kStages shared-memory stages. A
//   producer warp (in the forward and dq kernels one warp of a producer
//   warpgroup, which hands its registers to the two consumer warpgroups with
//   `setmaxnreg`: a block of 9 warps gets registers as one of 12) waits for a stage's `empty` mbarrier (one arrival per
//   consumer warp after its last wgmma on the stage has completed),
//   announces the bytes on the stage's `full` mbarrier and issues the
//   copies; consumers wait on `full`. So the next tile's copy is in flight
//   while this tile's products run, and the consumer warpgroups of a block
//   drift apart by up to a stage: one's softmax overlaps the other's wgmma.
// - Determinism: each output tile is summed by one warpgroup in tile order;
//   no atomics.
#pragma once

#include "flash_attention.cuh"
#include "hopper.cuh"

namespace smm {
namespace flashw {

namespace hp = smm::hopper;

constexpr int kSw = 64;       // swizzle width in bytes
constexpr int kAtomCols = 32;  // bf16 columns of one atom block
constexpr int kStages = 2;

// Bytes of a [ROWS][D] bf16 tile: D/32 atom blocks of ROWS * 64 bytes.
template <int D, int ROWS>
__host__ __device__ constexpr int tile_bytes() { return ROWS * D * 2; }

// Producer: copy rows [row0, row0 + ROWS) of head h of batch b into the
// tile at shared address `dst`; the map's box is [1][ROWS][32].
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int h, int row0, int b) {
#pragma unroll
  for (int c = 0; c < D / kAtomCols; ++c)
    hp::tma_load_3d(dst + c * ROWS * kSw, map, bar, h * D + c * kAtomCols, row0, b);
}

// Descriptor of a tile used K-major (contraction over d), for k16 step kk,
// starting at tile row `row` (a multiple of 8).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_over_d(uint32_t tile, int row, int kk) {
  return hp::desc_k_major<kSw>(tile + (kk >> 1) * ROWS * kSw + row * kSw + (kk & 1) * 32);
}

// Descriptor of a tile used MN-major as B (contraction over its rows), for
// k16 step kk (rows 16 kk .. 16 kk + 15); N runs over the D columns.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_over_rows(uint32_t tile, int kk) {
  return hp::desc_mn_major<kSw>(tile + kk * 16 * kSw, ROWS * kSw);
}

// acc (+)= A . B^T over d, A rows [row_a, row_a + 64) of tile `ta` (RA rows
// tall), B all N = RB rows of tile `tb`: D/16 k16 steps; overwrites acc.
template <int D, int RA, int RB>
__device__ __forceinline__ void mma_over_d(float (&acc)[RB / 2], uint32_t ta, int row_a,
                                           uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hp::wgmma_ss<RB, 0>(acc, desc_over_d<RA>(ta, row_a, kk), desc_over_d<RB>(tb, 0, kk), kk > 0);
}

// acc += A . B over the R rows of tile `tb` ([R][D], N = D), A = the packed
// registers `a` (R/4 of them: four per k16 step).
template <int D, int R>
__device__ __forceinline__ void mma_over_rows(float (&acc)[D / 2], const uint32_t (&a)[R / 4],
                                              uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    hp::wgmma_rs<D, 1>(acc, &a[4 * kk], desc_over_rows<R>(tb, kk), 1);
}

// This thread's place in a 64-row accumulator: its two rows (r, r + 8) in
// the warpgroup's tile and its first column of every 8-column block.
struct Lane {
  int r, c;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    r = warp * 16 + (lane >> 2);
    c = (lane & 3) * 2;
  }
};

// Sum / maximum over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Store a 64 x D accumulator as bf16 rows of a [B, S, H, D] tensor: `dst`
// points at (row 0 of the warpgroup's tile, column 0 of the head), rows
// from `rows_left` on are past the tensor's end.
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2], bf16* dst, long long token,
                                          int rows_left, const Lane& ln, float s0, float s1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + ln.c;
    if (ln.r < rows_left)
      *reinterpret_cast<uint32_t*>(dst + (size_t)ln.r * token + col) =
          hp::pack_bf16(acc[4 * j] * s0, acc[4 * j + 1] * s0);
    if (ln.r + 8 < rows_left)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(ln.r + 8) * token + col) =
          hp::pack_bf16(acc[4 * j + 2] * s1, acc[4 * j + 3] * s1);
  }
}

// Host: the tensor map of a [B, S, H, D] bf16 tensor with these batch and
// token strides (elements, positive; each token's H*D values dense), as three axes
// (H*D, S, B) with a box of [1][box_rows][32]. The wrapper guarantees a
// 16-byte aligned base and strides that are multiples of 8 elements.
inline int make_rows_map(CUtensorMap* map, const void* base, RowStrides s, int B, int S, int H,
                         int D, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)H * D, (uint64_t)S, (uint64_t)B};
  // an axis of one element may carry any stride: give it the dense one
  const uint64_t token = S > 1 ? (uint64_t)s.token : (uint64_t)H * D;
  const uint64_t batch = B > 1 ? (uint64_t)s.batch : token * S;
  const uint64_t strides[2] = {token * 2, batch * 2};
  const uint32_t box[3] = {kAtomCols, (uint32_t)box_rows, 1};
  return hp::make_tensor_map_bf16<kSw>(map, base, 3, dims, strides, box);
}

// Allow `bytes` of dynamic shared memory for a kernel (once is enough, the
// call is cheap) and report the error if the card refuses.
template <typename Kern>
inline int allow_smem(Kern k, int bytes) {
  return (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace flashw
}  // namespace smm
