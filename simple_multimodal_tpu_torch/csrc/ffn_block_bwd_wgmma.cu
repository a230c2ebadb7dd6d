// The two products of the FFN backward over one [M, F] tile, on wgmma and
// TMA, with the pre-activation kept in registers:
//   acc_h = a . W1[:, tile]      (a = xn or x, [M, E])
//   acc_d = dy0 . W2[tile, :]^T
//   h     = drop_mid(gelu(acc_h + b1))                        -> bf16 (dW2's operand)
//   dhp   = gelu'(acc_h + b1) * drop_mid(acc_d)               -> bf16 (dW1's and dxn's)
//   db1's partial: per 128-row strip, the column sums of the bf16-rounded dhp.
//
// Replaces the body of simple_multimodal_tpu/ops/pallas/ffn_block.py's
// `_bwd_kernel` (via `_ffn_bwd`) that recomputes `hp_c` per [Rb, Fc] chunk
// and keeps it in VMEM beside `dh_c`: here the f32 pre-activation never
// reaches device memory either (kept there as f32 [M, F], it would cost ~1.7
// GB of traffic a call at the ViT site: written once, read twice).
// GELU and its derivative are the tanh forms of common.cuh (the bf16 path's),
// the dropout ffn_keep's hash with salt kSaltMid, element for element the
// values of the GEMM epilogues they replace: the forward's GEMM1 (bias, GELU,
// dropout) and the backward's ACT_DGELU_TANH pass (dropout, times gelu').
//
// What bounds it on this card: operations (two products of 2 M E F each, K =
// E = 768: 0.23 ms of tensor-core time at the ViT site), with the same short
// K as the forward's GEMMs. The design is gemm_wgmma.cu's: two consumer
// warpgroups of 64 rows, no producer warpgroup (thread 0 refills a stage once
// both warpgroups let go of it), a TMA ring of stages, the epilogue on the
// accumulator registers in their own layout (hopper.cuh). A stage holds the
// a and dy0 boxes of [128][64] (K-major) and the two weights' boxes in the
// torch layouts the model holds them in, so no weight is copied: W1 as w1t
// [F, E], K-major, one [BN][64] box; W2 as w2t [E, F], MN-major (the
// contraction runs down its rows), BN/64 boxes of [64][64] read with the
// trans-b descriptor. Each K step chains both products in one committed
// group. The tile is 128 x 128: two 64-register accumulators, one block an
// SM, three 64 KB stages. (A 128 x 64 tile at two blocks an SM was 9-20%
// slower at every M measured, and F is a multiple of 128 at every site.)
// Rows past M arrive from TMA as zeros and are masked at the stores and in
// the column sums. The column sums go by shuffles over a warp's rows and
// through shared memory over the eight warps, in a fixed order, and the fold
// over strips (fold_columns_kernel) is fixed too: two runs give the same bits.

#include "ffn_block_bwd_wgmma.cuh"
#include "gemm.cuh"
#include "hopper.cuh"

namespace smm {
namespace {

namespace hp = smm::hopper;

constexpr int kBM = 128;  // rows of a block tile: two warpgroups of 64
constexpr int kBK = 64;   // K step: one 128-byte swizzle atom per row
constexpr int kSw = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kABytes = kBM * kBK * 2;  // one [128][64] box
constexpr int kBN = 128;                // columns of a block tile
constexpr int kWBytes = kBN * kBK * 2;  // one weight's boxes
constexpr int kStageBytes = 2 * kABytes + 2 * kWBytes;  // 64 KB
constexpr int kStages = 3;
constexpr int kRed = kStages * kStageBytes;  // [8 warps][kBN] f32 column sums
constexpr int kBars = kRed + kWarps * kBN * 4;
constexpr int kSmemBytes = kBars + 16 * kStages + 1024;

struct Maps {
  CUtensorMap a, d, w1, w2;
};

struct Args {
  int M, K, F, S;
  const bf16* b1;
  Drop mid;
  bf16* h;  // or null
  bf16* dhp;
  float* part;
};

__device__ __forceinline__ float2 bf16_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_wgmma_kernel(const __grid_constant__ Maps maps, const Args g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t tiles = hp::smem_u32(smem);
  const uint32_t full = tiles + kBars, empty = full + 8 * kStages;
  float* red = reinterpret_cast<float*>(smem + kRed);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nk = g.K / kBK;

  // thread 0: K step kt's four operands into its stage
  auto load_step = [&](int kt) {
    const int s = kt % kStages;
    const uint32_t dst = tiles + s * kStageBytes, bar = full + 8 * s;
    hp::mbar_arrive_expect_tx(bar, kStageBytes);
    hp::tma_load_2d(dst, &maps.a, bar, kt * kBK, m0);
    hp::tma_load_2d(dst + kABytes, &maps.d, bar, kt * kBK, m0);
    hp::tma_load_2d(dst + 2 * kABytes, &maps.w1, bar, kt * kBK, n0);
#pragma unroll
    for (int a = 0; a < kBN / 64; ++a)
      hp::tma_load_2d(dst + 2 * kABytes + kWBytes + a * 64 * kSw, &maps.w2, bar, n0 + 64 * a,
                      kt * kBK);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, kWarps);
    }
    hp::mbar_fence_init();
    for (int kt = 0; kt < kStages && kt < nk; ++kt) load_step(kt);
  }
  __syncthreads();

  float acc_h[kBN / 2], acc_d[kBN / 2];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    hp::mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t st = tiles + s * kStageBytes;
    const uint32_t As = st + wg * 64 * kSw, Ds = st + kABytes + wg * 64 * kSw;
    const uint32_t W1s = st + 2 * kABytes, W2s = W1s + kWBytes;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hp::wgmma_ss<kBN, 0>(acc_h, hp::desc_k_major<kSw>(As + kk * 32),
                          hp::desc_k_major<kSw>(W1s + kk * 32), (kt | kk) != 0);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hp::wgmma_ss<kBN, 1>(acc_d, hp::desc_k_major<kSw>(Ds + kk * 32),
                          hp::desc_mn_major<kSw>(W2s + kk * 16 * kSw, 64 * kSw), (kt | kk) != 0);
    hp::wgmma_commit();
    if (kt > 0) {  // the previous step's products are done: its stage is free
      hp::wgmma_wait<1>();
      const int sp = (kt - 1) % kStages;
      if (lane == 0) hp::mbar_arrive(empty + 8 * sp);
      if (threadIdx.x == 0 && kt - 1 + kStages < nk) {  // refill it once every warp has let go
        hp::mbar_wait(empty + 8 * sp, ((kt - 1) / kStages) & 1);
        load_step(kt - 1 + kStages);
      }
      __syncwarp();
    }
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(acc_h);
  hp::fence_regs(acc_d);

  // the epilogue, on this thread's two rows and its column pair of every
  // 8-column block
  const int lc = (lane & 3) * 2;
  const bool dropping = g.mid.seed != nullptr;
  const uint32_t seed = dropping ? (uint32_t)*g.mid.seed + (uint32_t)kSaltMid : 0u;
  const float sc = g.mid.scale;
  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = r0 < g.M, ok1 = r1 < g.M;
  uint32_t h0 = 0, h1 = 0;
  if (dropping) {  // (b, s) = (r / S, r % S) and the hash's row part, once per row
    h0 = hash_row(seed, r0 / g.S, r0 % g.S);
    h1 = hash_row(seed, r1 / g.S, r1 % g.S);
  }
  const size_t o0 = (size_t)r0 * g.F, o1 = (size_t)r1 * g.F;
#pragma unroll
  for (int jb = 0; jb < kBN / 8; ++jb) {
    const int c = n0 + 8 * jb + lc;
    const float2 b = bf16_pair(g.b1 + c);
    float hv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // e: (row r0, c), (r0, c + 1), (r1, c), (r1, c + 1)
      const float pre = acc_h[4 * jb + e] + ((e & 1) ? b.y : b.x);
      float v = gelu_tanh(pre), d = acc_d[4 * jb + e];
      if (dropping) {
        const bool keep = hash_row_keep(e < 2 ? h0 : h1, c + (e & 1), g.mid.thresh);
        v = keep ? v * sc : 0.0f;
        d = keep ? d * sc : 0.0f;
      }
      hv[e] = v;
      dv[e] = d * gelu_grad(pre, ACT_GELU_TANH);
    }
    const uint32_t d01 = hp::pack_bf16(dv[0], dv[1]), d23 = hp::pack_bf16(dv[2], dv[3]);
    if (ok0) *reinterpret_cast<uint32_t*>(g.dhp + o0 + c) = d01;
    if (ok1) *reinterpret_cast<uint32_t*>(g.dhp + o1 + c) = d23;
    if (g.h) {
      if (ok0) *reinterpret_cast<uint32_t*>(g.h + o0 + c) = hp::pack_bf16(hv[0], hv[1]);
      if (ok1) *reinterpret_cast<uint32_t*>(g.h + o1 + c) = hp::pack_bf16(hv[2], hv[3]);
    }
    // db1: the rounded values, summed over the warp's 16 rows (lanes with
    // the same lane % 4 hold the same columns), then over the eight warps below
    const float2 f01 = unpack_bf16(d01), f23 = unpack_bf16(d23);
    float s0 = (ok0 ? f01.x : 0.0f) + (ok1 ? f23.x : 0.0f);
    float s1 = (ok0 ? f01.y : 0.0f) + (ok1 ? f23.y : 0.0f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane < 4) {
      red[warp * kBN + 8 * jb + lc] = s0;
      red[warp * kBN + 8 * jb + lc + 1] = s1;
    }
  }
  __syncthreads();
  if (threadIdx.x < kBN) {
    float s = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * kBN + threadIdx.x];
    g.part[(size_t)blockIdx.y * g.F + n0 + threadIdx.x] = s;
  }
}

// A [rows, cols] bf16 matrix with row stride ld (elements) as a two-axis map
// whose box is [box_rows][64].
int make_map(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return hp::make_tensor_map_bf16<kSw>(map, base, 2, dims, strides, box);
}

}  // namespace

int ffn_bwd_wgmma_launch(const bf16* a, const bf16* dy0, const bf16* w1t, const bf16* b1,
                         const bf16* w2t, int M, int E, int F, int S, Drop mid, bf16* h,
                         bf16* dhp, float* part, cudaStream_t st) {
  if (M <= 0) return 0;
  if (!ffn_bwd_wgmma_takes(true, E, F)) return (int)cudaErrorInvalidValue;
  static const int allowed = (int)cudaFuncSetAttribute(
      ffn_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (allowed != 0) return allowed;
  Maps maps;
  if (int e = make_map(&maps.a, a, M, E, E, kBM)) return e;
  if (int e = make_map(&maps.d, dy0, M, E, E, kBM)) return e;
  if (int e = make_map(&maps.w1, w1t, F, E, E, kBN)) return e;  // [F, E]: K-major
  if (int e = make_map(&maps.w2, w2t, E, F, F, 64)) return e;   // [E, F]: MN-major
  const Args g{M, E, F, S, b1, mid, h, dhp, part};
  const dim3 grid(F / kBN, (M + kBM - 1) / kBM);
  ffn_bwd_wgmma_kernel<<<grid, kThreads, kSmemBytes, st>>>(maps, g);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace smm

using namespace smm;

// The two-product kernel alone (ffn_bwd_wgmma_launch; bf16): a, dy0 [M, E],
// w1t [F, E], b1 [F], w2t [E, F]; seed a device int32 [1] or null (no
// dropout) with thresh and scale; h [M, F] or null, dhp [M, F]; part f32
// [ceil(M / 128), F]; db1 f32 [F], the fold of part. Returns the first CUDA
// error, or 0.
extern "C" int smm_ffn_bwd_mm(const void* a, const void* dy0, const void* w1t, const void* b1,
                              const void* w2t, int M, int E, int F, int S, const int* seed,
                              unsigned thresh, float scale, void* h, void* dhp, float* part,
                              float* db1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (int e = ffn_bwd_wgmma_launch((const bf16*)a, (const bf16*)dy0, (const bf16*)w1t,
                                   (const bf16*)b1, (const bf16*)w2t, M, E, F, S,
                                   Drop{seed, thresh, scale}, (bf16*)h, (bf16*)dhp, part, st))
    return e;
  return launch_fold_columns(part, (M + 127) / 128, F, db1, st);
}

// The route of an FFN backward (dtype: 0 = f32, 1 = bf16): 1 = the wgmma
// chain, 0 = gemm.cuh's.
extern "C" int smm_ffn_bwd_route(int dtype, int E, int F) {
  return ffn_bwd_wgmma_takes(dtype == 1, E, F) ? 1 : 0;
}

// The two-product kernel's dynamic shared memory, in bytes.
extern "C" int smm_ffn_bwd_wgmma_smem() { return kSmemBytes; }
