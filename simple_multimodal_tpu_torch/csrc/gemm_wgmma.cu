// The bf16 GEMM of the port on wgmma and TMA, with the fused epilogue of
// gemm_wgmma.cuh:  out[M, N] = drop(act(A[M, K] . W[N, K]^T + bias)) (+ res).
//
// It is the product under ffn_block (both GEMMs) and attention_block (the
// q|k|v projection as one launch over three weights, and the
// out-projection), forward and backward chains alike, for every bf16 shape
// gemm_wgmma_takes accepts; gemm.cuh's WMMA kernel keeps the rest.
//
// What bounds it on this card: operations. The main path's products are
// [47 280 or ~4 000 rows] x [768, 2 304 or 3 072] over K = 768 (3 072 once):
// short K, so filling the ring and the epilogue are a large share of a
// tile's life, and the epilogue (bias, GELU, hash dropout, residual, 4-byte
// stores) is ALU work that the tensor cores would otherwise wait for.
//
// What the design does about it:
// - Both operands are K-major. TMA copies [128][64] (A) and [tile_n][64] (W)
//   boxes, one 128-byte swizzle atom per row, into a ring of stages; rows
//   past M arrive as zeros, so a ragged M needs no padding and only the
//   stores are masked.
// - A block is two warpgroups, each chaining m64n{tile_n}k16 wgmma over its
//   64 rows of a 128 x tile_n tile, with one committed group in flight while
//   the next stage is waited for. There is no producer warpgroup: thread 0
//   refills a stage as soon as both warpgroups have released it, two K steps
//   ahead of the products.
// - Two blocks are resident on an SM (a ring is 96 KB; 256 threads at 128
//   registers): one block's launch, ring fill and epilogue overlap the
//   other's products, which is what a short K needs. ptxas allots every
//   thread the launch bound's register count whatever setmaxnreg says later,
//   so a block with a third, producer warpgroup (384 threads, 80 registers
//   for two blocks an SM) cannot hold the 64-register accumulator.
// - The epilogue runs on the accumulator registers in their own layout
//   (hopper.cuh): a thread owns two rows, so (b, s) = (r / S, r % S) and the
//   row part of the dropout hash are formed once per row, not per element;
//   bias, residual, pre-activation and stores go by column pairs.
// - Tile shape by shape: 128 x 128, or 128 x 64 where that takes an eighth
//   or more off the busiest SM's share of the tiles (the ~4 000-row sites at
//   N = 768: 192 tiles on 132 SMs) or N is no multiple of 128.
// - Block order: the N tiles of one 128-row strip are neighbours in launch
//   order, so a strip of A is read from device memory once and the weights
//   stay in L2.
// What still bounds it (PERF.md has the numbers): a tile costs about 2.7 us
// beside its K steps, mostly the epilogue, which the second block covers
// only in part, and the K steps run at ~60% of the tensor cores' rate: at
// m64n128k16 with both operands in shared memory, the operand reads (96
// bytes a clock at full rate) and TMA's writes (64) exceed the 128 bytes a
// clock that shared memory moves. Tried on the card and dropped, each slower
// or no faster at K = 768: one block an SM with a producer warpgroup (no
// overlap); one persistent block an SM whose two warpgroups alternate whole
// tiles (128 accumulators spill); persistent blocks of this shape that
// stream their tiles' K steps through one ring; a cluster of two blocks
// sharing the A boxes by TMA multicast (the blocks wait on each other's
// stages). Wider wgmma tiles (n = 256) and an epilogue staged through shared
// memory with TMA stores are later work.

#include <time.h>

#include "gemm.cuh"
#include "hopper.cuh"

namespace smm {
namespace {

namespace hp = smm::hopper;

constexpr int kBM = 128;  // rows of a block tile: two warpgroups of 64
constexpr int kBK = 64;   // K step: one 128-byte swizzle atom per row
constexpr int kSw = 128;  // swizzle width in bytes
constexpr int kWarps = kBM / 64 * 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 2;
constexpr int kABytes = kBM * kBK * 2;
constexpr int kRingBytes = 96 * 1024;

template <int BN>
struct Plan {
  static constexpr int stage_bytes = kABytes + BN * kBK * 2;
  static constexpr int stages = kRingBytes / stage_bytes;  // 3 at 128 columns, 4 at 64
  static constexpr int bars = stages * stage_bytes;        // full[], empty[]
  static constexpr int bytes = bars + 16 * stages + 1024;
};

struct GemmMaps {
  CUtensorMap a, w0, w1, w2;
};

struct GemmArgs {
  int M, K, group_n;
  const void *bias0, *bias1, *bias2;
  Epilogue ep;
};

__device__ __forceinline__ float2 bf16_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int BN>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gemm_wgmma_kernel(const __grid_constant__ GemmMaps maps, const GemmArgs g) {
  using P = Plan<BN>;
  constexpr int kStages = P::stages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = hp::smem_u32(hp::align_1024(smem_raw));
  const uint32_t full = tiles + P::bars, empty = full + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int group = n0 / g.group_n, nl0 = n0 - group * g.group_n;  // this tile's weight, its row
  const CUtensorMap* mw = group == 0 ? &maps.w0 : group == 1 ? &maps.w1 : &maps.w2;
  const int nk = g.K / kBK;

  // thread 0: K step kt's boxes into its stage
  auto load_step = [&](int kt) {
    const int s = kt % kStages;
    const uint32_t dst = tiles + s * P::stage_bytes;
    hp::mbar_arrive_expect_tx(full + 8 * s, P::stage_bytes);
    hp::tma_load_2d(dst, &maps.a, full + 8 * s, kt * kBK, m0);
    hp::tma_load_2d(dst + kABytes, mw, full + 8 * s, kt * kBK, nl0);
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

  float acc[BN / 2];
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    hp::mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint32_t As = tiles + s * P::stage_bytes + wg * 64 * kSw;
    const uint32_t Bs = tiles + s * P::stage_bytes + kABytes;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hp::wgmma_ss<BN, 0>(acc, hp::desc_k_major<kSw>(As + kk * 32),
                          hp::desc_k_major<kSw>(Bs + kk * 32), (kt | kk) != 0);
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
  hp::fence_regs(acc);

  const Epilogue& ep = g.ep;
  const int lc = (lane & 3) * 2;
  const bool dropping = ep.drop.seed != nullptr;
  const uint32_t seed = dropping ? (uint32_t)*ep.drop.seed + (uint32_t)ep.salt : 0u;
  const bool gelu = ep.act == ACT_GELU_ERF || ep.act == ACT_GELU_TANH;
  const bool dgelu = ep.act == ACT_DGELU_ERF || ep.act == ACT_DGELU_TANH;
  const bf16* bias = (const bf16*)(group == 0 ? g.bias0 : group == 1 ? g.bias1 : g.bias2);
  // the epilogue, on this thread's two rows and its column pair of every
  // 8-column block
  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;
  const bool ok0 = r0 < g.M, ok1 = r1 < g.M;
  uint32_t h0 = 0, h1 = 0;
  if (dropping) {  // (b, s) = (r / S, r % S) and the hash's row part, once per row
    h0 = hash_row(seed, r0 / ep.drop_S, r0 % ep.drop_S);
    h1 = hash_row(seed, r1 / ep.drop_S, r1 % ep.drop_S);
  }
  const size_t o0 = (size_t)r0 * ep.ldc, o1 = (size_t)r1 * ep.ldc;
  const size_t q0 = (size_t)r0 * ep.ldr, q1 = (size_t)r1 * ep.ldr;
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    const int c = n0 + 8 * jb + lc;
    float v00 = acc[4 * jb], v01 = acc[4 * jb + 1];
    float v10 = acc[4 * jb + 2], v11 = acc[4 * jb + 3];
    if (bias) {
      const float2 b = bf16_pair(bias + nl0 + 8 * jb + lc);
      v00 += b.x, v01 += b.y, v10 += b.x, v11 += b.y;
    }
    if (gelu) {
      v00 = apply_act(v00, ep.act), v01 = apply_act(v01, ep.act);
      v10 = apply_act(v10, ep.act), v11 = apply_act(v11, ep.act);
    }
    if (dropping) {
      const float sc = ep.drop.scale;
      v00 = hash_row_keep(h0, c, ep.drop.thresh) ? v00 * sc : 0.0f;
      v01 = hash_row_keep(h0, c + 1, ep.drop.thresh) ? v01 * sc : 0.0f;
      v10 = hash_row_keep(h1, c, ep.drop.thresh) ? v10 * sc : 0.0f;
      v11 = hash_row_keep(h1, c + 1, ep.drop.thresh) ? v11 * sc : 0.0f;
    }
    if (dgelu) {
      if (ok0) {
        const float2 x = *reinterpret_cast<const float2*>(ep.aux + o0 + c);
        v00 *= gelu_grad(x.x, ep.act - 2), v01 *= gelu_grad(x.y, ep.act - 2);
      }
      if (ok1) {
        const float2 x = *reinterpret_cast<const float2*>(ep.aux + o1 + c);
        v10 *= gelu_grad(x.x, ep.act - 2), v11 *= gelu_grad(x.y, ep.act - 2);
      }
    }
    if (ep.res) {
      if (ep.res_f32) {
        const float* res = (const float*)ep.res;
        if (ok0) {
          const float2 x = *reinterpret_cast<const float2*>(res + q0 + c);
          v00 += x.x, v01 += x.y;
        }
        if (ok1) {
          const float2 x = *reinterpret_cast<const float2*>(res + q1 + c);
          v10 += x.x, v11 += x.y;
        }
      } else {
        const bf16* res = (const bf16*)ep.res;
        if (ok0) {
          const float2 x = bf16_pair(res + q0 + c);
          v00 += x.x, v01 += x.y;
        }
        if (ok1) {
          const float2 x = bf16_pair(res + q1 + c);
          v10 += x.x, v11 += x.y;
        }
      }
    }
    if (ep.out_f32) {
      float* out = (float*)ep.out;
      if (ok0) *reinterpret_cast<float2*>(out + o0 + c) = make_float2(v00, v01);
      if (ok1) *reinterpret_cast<float2*>(out + o1 + c) = make_float2(v10, v11);
    } else {
      bf16* out = (bf16*)ep.out;
      if (ok0) *reinterpret_cast<uint32_t*>(out + o0 + c) = hp::pack_bf16(v00, v01);
      if (ok1) *reinterpret_cast<uint32_t*>(out + o1 + c) = hp::pack_bf16(v10, v11);
    }
  }
}

// A [rows, K] bf16 matrix with row stride ld (elements) as a two-axis map
// whose box is [box_rows][64].
int make_k_major_map(CUtensorMap* map, const void* base, int rows, int K, int ld, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)ld * 2};
  const uint32_t box[2] = {kBK, (uint32_t)box_rows};
  return hp::make_tensor_map_bf16<kSw>(map, base, 2, dims, strides, box);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return sms;
  }();
  return n;
}

template <int BN>
int launch(const bf16* A, int lda, const bf16* const* W, int ldw, const void* const* bias,
           int groups, int M, int group_n, int K, const Epilogue& ep, cudaStream_t st) {
  constexpr int bytes = Plan<BN>::bytes;
  static const int allowed = (int)cudaFuncSetAttribute(
      gemm_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (allowed != 0) return allowed;
  // unused weight slots repeat the first: every map is valid
  const int i1 = groups > 1 ? 1 : 0, i2 = groups > 2 ? 2 : 0;
  GemmMaps maps;
  const GemmArgs g{M, K, group_n, bias[0], bias[i1], bias[i2], ep};
  if (int e = make_k_major_map(&maps.a, A, M, K, lda, kBM)) return e;
  if (int e = make_k_major_map(&maps.w0, W[0], group_n, K, ldw, BN)) return e;
  if (int e = make_k_major_map(&maps.w1, W[i1], group_n, K, ldw, BN)) return e;
  if (int e = make_k_major_map(&maps.w2, W[i2], group_n, K, ldw, BN)) return e;
  const dim3 grid(groups * group_n / BN, (M + kBM - 1) / kBM);
  gemm_wgmma_kernel<BN><<<grid, kThreads, bytes, st>>>(maps, g);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace

int gemm_wgmma_tile_n(int M, int N, int group_n) {
  if (group_n % 128) return 64;
  // the busiest SM's share of the tiles, in units of a 128 x 64 tile
  const long long sms = sm_count(), t128 = (long long)((M + kBM - 1) / kBM) * (N / 128);
  const long long wide = (t128 + sms - 1) / sms * 2, narrow = (2 * t128 + sms - 1) / sms;
  return narrow * 8 <= wide * 7 ? 64 : 128;
}

int gemm_wgmma_launch(const bf16* A, int lda, const bf16* const* W, int ldw,
                      const void* const* bias, int groups, int M, int group_n, int K,
                      const Epilogue& ep, cudaStream_t st) {
  if (M <= 0) return 0;
  if (groups < 1 || groups > 3) return (int)cudaErrorInvalidValue;
  if (gemm_wgmma_tile_n(M, groups * group_n, group_n) == 128)
    return launch<128>(A, lda, W, ldw, bias, groups, M, group_n, K, ep, st);
  return launch<64>(A, lda, W, ldw, bias, groups, M, group_n, K, ep, st);
}

int gemm_wgmma_smem(int tile_n) {
  return tile_n == 128 ? Plan<128>::bytes : tile_n == 64 ? Plan<64>::bytes : 0;
}

}  // namespace smm

using namespace smm;

// The bf16 GEMM alone, as the blocks' chains call it (launch_gemm: the
// wgmma kernel where gemm_wgmma_takes the shape, the WMMA kernel otherwise).
// a [M, K] (row stride lda), w [N, K] (ldw), bias [N] or null, res [M, ldr]
// bf16 (f32 with res_f32) or null, out [M, ldc] bf16 (f32 with out_f32), act
// an Act code, aux [M, ldc] f32 for ACT_DGELU_*, seed a device int32 [1] or
// null (no dropout) with thresh, scale, salt and S of the FFN scheme.
// Returns the first CUDA error, or 0.
extern "C" int smm_gemm(const void* a, int lda, const void* w, int ldw, const void* bias,
                        const void* res, int ldr, int res_f32, void* out, int ldc, int out_f32,
                        int act, const float* aux, const int* seed, unsigned thresh, float scale,
                        int salt, int drop_S, int M, int N, int K, void* stream) {
  const Epilogue ep{bias, res, ldr, out, ldc, act, out_f32, res_f32, Drop{seed, thresh, scale},
                    salt, drop_S, aux};
  return launch_gemm((const bf16*)a, lda, (const bf16*)w, ldw, M, N, K, ep, (cudaStream_t)stream);
}

// The kernel smm_gemm picks for these operands: 0 = WMMA, else the wgmma
// kernel's tile width (64 or 128).
extern "C" int smm_gemm_route(const void* a, int lda, const void* w, int ldw, const void* bias,
                              const void* res, int ldr, void* out, int ldc, const float* aux,
                              int M, int N, int K) {
  const Epilogue ep{bias, res, ldr, out, ldc, ACT_NONE, 0, 0, Drop{nullptr, 0, 1.0f}, 0, 0, aux};
  return gemm_wgmma_takes(a, lda, w, ldw, N, K, ep) ? gemm_wgmma_tile_n(M, N, N) : 0;
}

extern "C" int smm_gemm_wgmma_smem(int tile_n) { return gemm_wgmma_smem(tile_n); }

// Host nanoseconds to encode one tensor map (the wgmma chains build theirs
// per call), averaged over `reps`; negative on an error.
extern "C" int smm_tensor_map_ns(const void* base, int rows, int K, int reps) {
  CUtensorMap map;
  timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (int i = 0; i < reps; ++i)
    if (make_k_major_map(&map, base, rows, K, K, kBM)) return -1;
  clock_gettime(CLOCK_MONOTONIC, &t1);
  const double ns = (t1.tv_sec - t0.tv_sec) * 1e9 + (t1.tv_nsec - t0.tv_nsec);
  return (int)(ns / (reps > 0 ? reps : 1));
}
