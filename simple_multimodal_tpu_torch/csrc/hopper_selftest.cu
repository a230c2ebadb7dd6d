// Self-test kernels for csrc/hopper.cuh: they prove, on small exact cases,
// the claims the wgmma kernels are built on. Called by
// ops/hopper/selftest.py; no model path runs them.
//
// - smm_hopper_selftest_mma: C = A . Bt^T with A [64, 64] and Bt [N, 64]
//   both loaded by TMA (64-byte swizzle) and used K-major (`wgmma_ss`,
//   `desc_k_major`); then O = bf16(C[:, :64]) . V with the accumulator
//   packed pairwise as the A registers (`wgmma_rs`) and V [64, N] used
//   MN-major (`desc_mn_major`, trans-b). With small integer
//   inputs both results are exact, so the host compares for equality: a
//   wrong fragment layout, descriptor or swizzle cannot hide in rounding.
// - smm_hopper_selftest_swizzle: one TMA box of [64 rows][SW/2 columns], SW
//   = 32, 64 or 128 bytes, at an offset that may hang over the matrix's
//   edge, read back element by element through `swizzle_offset<SW>`: the
//   layout TMA writes is the one the helper computes, and out-of-range
//   elements arrive as zeros.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace smm;
namespace hp = smm::hopper;

constexpr int kSw = 64, kAtomCols = 32;

template <int N>
__global__ void __launch_bounds__(128) selftest_mma_kernel(const __grid_constant__ CUtensorMap ma,
                                                           const __grid_constant__ CUtensorMap mb,
                                                           const __grid_constant__ CUtensorMap mv,
                                                           float* c, float* o) {
  constexpr int K2 = 64;  // contraction depth of the second product
  constexpr int a_bytes = 64 * 64 * 2, b_bytes = N * 64 * 2, v_bytes = K2 * N * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t As = hp::smem_u32(smem), Bs = As + a_bytes, Vs = Bs + b_bytes,
                 bar = Vs + v_bytes;
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, a_bytes + b_bytes + v_bytes);
    for (int blk = 0; blk < 2; ++blk) {  // 64 contraction columns = two atom blocks
      hp::tma_load_2d(As + blk * 64 * kSw, &ma, bar, blk * kAtomCols, 0);
      hp::tma_load_2d(Bs + blk * N * kSw, &mb, bar, blk * kAtomCols, 0);
    }
    for (int blk = 0; blk < N / kAtomCols; ++blk)
      hp::tma_load_2d(Vs + blk * K2 * kSw, &mv, bar, blk * kAtomCols, 0);
  }
  hp::mbar_wait(bar, 0);

  float acc[N / 2];
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hp::wgmma_ss<N, 0>(acc, hp::desc_k_major<kSw>(As + (kk >> 1) * 64 * kSw + (kk & 1) * 32),
                       hp::desc_k_major<kSw>(Bs + (kk >> 1) * N * kSw + (kk & 1) * 32), kk > 0);
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = warp * 16 + (lane >> 2), col = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      c[r * N + 8 * j + col + e] = acc[4 * j + e];
      c[(r + 8) * N + 8 * j + col + e] = acc[4 * j + 2 + e];
    }

  uint32_t a[K2 / 4];
#pragma unroll
  for (int n = 0; n < K2 / 4; ++n) a[n] = hp::pack_bf16(acc[2 * n], acc[2 * n + 1]);
  float out[N / 2];
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K2 / 16; ++kk)
    hp::wgmma_rs<N, 1>(out, &a[4 * kk], hp::desc_mn_major<kSw>(Vs + kk * 16 * kSw, K2 * kSw),
                       kk > 0);
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(out);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      o[r * N + 8 * j + col + e] = out[4 * j + e];
      o[(r + 8) * N + 8 * j + col + e] = out[4 * j + 2 + e];
    }
}

template <int SW>
int map_2d(CUtensorMap* m, const void* base, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {SW / 2, (uint32_t)box_rows};
  return hp::make_tensor_map_bf16<SW>(m, base, 2, dims, strides, box);
}

template <int N>
int run_mma(const void* a, const void* bt, const void* v, float* c, float* o, cudaStream_t st) {
  constexpr int K2 = 64;
  CUtensorMap ma, mb, mv;
  if (int e = map_2d<kSw>(&ma, a, 64, 64, 64)) return e;
  if (int e = map_2d<kSw>(&mb, bt, N, 64, N)) return e;
  if (int e = map_2d<kSw>(&mv, v, K2, N, K2)) return e;
  constexpr int bytes = 64 * 64 * 2 + N * 64 * 2 + K2 * N * 2 + 8 + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      selftest_mma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  selftest_mma_kernel<N><<<1, 128, bytes, st>>>(ma, mb, mv, c, o);
  SMM_CHECK_LAUNCH();
  return 0;
}

template <int SW>
__global__ void selftest_swizzle_kernel(const __grid_constant__ CUtensorMap m, bf16* out, int c0,
                                        int r0) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align_1024(smem_raw);
  const uint32_t tile = hp::smem_u32(smem), bar = tile + 64 * SW;
  if (threadIdx.x == 0) {
    hp::mbar_init(bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hp::mbar_arrive_expect_tx(bar, 64 * SW);
    hp::tma_load_2d(tile, &m, bar, c0, r0);
  }
  hp::mbar_wait(bar, 0);
  for (int e = threadIdx.x; e < 64 * (SW / 2); e += blockDim.x) {
    const int r = e / (SW / 2), col = e % (SW / 2);
    out[e] = *reinterpret_cast<const bf16*>(smem + hp::swizzle_offset<SW>(r * SW + col * 2));
  }
}

template <int SW>
int run_swizzle(const void* src, void* out, int rows, int cols, int r0, int c0, cudaStream_t st) {
  CUtensorMap m;
  if (int e = map_2d<SW>(&m, src, rows, cols, 64)) return e;
  selftest_swizzle_kernel<SW><<<1, 128, 64 * SW + 8 + 1024, st>>>(m, (bf16*)out, c0, r0);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// a [64, 64], bt [N, 64], v [64, N] bf16 dense; c, o [64, N] f32. N in
// {64, 96, 128}. Returns the first CUDA error, or 0.
extern "C" int smm_hopper_selftest_mma(int N, const void* a, const void* bt, const void* v,
                                       float* c, float* o, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 64: return run_mma<64>(a, bt, v, c, o, st);
    case 96: return run_mma<96>(a, bt, v, c, o, st);
    case 128: return run_mma<128>(a, bt, v, c, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// src [rows, cols] bf16 dense (cols a multiple of 8); out [64, sw / 2] bf16 =
// src[r0 : r0 + 64, c0 : c0 + sw / 2], zeros outside the matrix; sw = the
// swizzle width in bytes, 32, 64 or 128.
extern "C" int smm_hopper_selftest_swizzle(int sw, const void* src, void* out, int rows,
                                           int cols, int r0, int c0, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (sw) {
    case 32: return run_swizzle<32>(src, out, rows, cols, r0, c0, st);
    case 64: return run_swizzle<64>(src, out, rows, cols, r0, c0, st);
    case 128: return run_swizzle<128>(src, out, rows, cols, r0, c0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
