// Tiled GEMM with a fused epilogue, and a LayerNorm row kernel: the two
// building blocks that attention_block.cu and ffn_block.cu chain.
//
//   out[M, N] = drop(act(A[M, K] . W[N, K]^T + bias)) (+ res)
//
// W is in torch Linear layout ([out, in], K contiguous), so both operands
// are K-major. bf16 inputs run on the tensor cores through WMMA (16x16x16,
// f32 accumulators) from a two-stage cp.async pipeline in shared memory;
// f32 inputs run a plain shared-memory tiled FMA loop, so an f32 call sums
// in full f32 (no TF32). The epilogue adds the bias, applies the GELU,
// applies the FFN hash dropout, adds the residual and stores in the input
// type or in f32 (the contract is `Epilogue` in gemm_wgmma.cuh).
//
// bf16 products whose shape and alignment the wgmma/TMA kernel takes
// (gemm_wgmma_takes: N and K multiples of 64, 16-byte aligned rows; every
// product of the base widths) go to gemm_wgmma.cu instead; the WMMA kernel
// here keeps the rest (the tiny preset's widths). That is decided from the
// arguments before anything is launched, never after a failure.
#pragma once

#include <mma.h>

#include "gemm_wgmma.cuh"

namespace smm {

template <typename T>
__device__ __forceinline__ void epilogue_store(const Epilogue& ep, int r, int c, float v) {
  if (ep.bias) v += to_f32(((const T*)ep.bias)[c]);
  if (ep.act == ACT_GELU_ERF || ep.act == ACT_GELU_TANH) v = apply_act(v, ep.act);
  if (ep.drop.seed) {
    const uint32_t seed = (uint32_t)*ep.drop.seed + (uint32_t)ep.salt;
    v = hash_keep(seed, r / ep.drop_S, r % ep.drop_S, c, ep.drop.thresh) ? v * ep.drop.scale : 0.0f;
  }
  if (ep.act == ACT_DGELU_ERF || ep.act == ACT_DGELU_TANH)
    v *= gelu_grad(ep.aux[(size_t)r * ep.ldc + c], ep.act - 2);
  if (ep.res)
    v += ep.res_f32 ? ((const float*)ep.res)[(size_t)r * ep.ldr + c]
                    : to_f32(((const T*)ep.res)[(size_t)r * ep.ldr + c]);
  if (ep.out_f32)
    ((float*)ep.out)[(size_t)r * ep.ldc + c] = v;
  else
    ((T*)ep.out)[(size_t)r * ep.ldc + c] = from_f32<T>(v);
}

// ---------------------------------------------------------------- bf16 WMMA

constexpr int kGemmBM = 128, kGemmBN = 64, kGemmBK = 32;
constexpr int kGemmLds = kGemmBK + 8;  // row pitch: keeps rows 16-byte aligned

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 256 threads = 8 warps in a 4 (M) x 2 (N) grid; each warp owns 32x32 of
// the 128x64 block tile as 2x2 WMMA accumulators. Needs K % 8 == 0 and
// 16-byte aligned rows (lda, ldw multiples of 8), which the wrapper checks.
static __global__ void __launch_bounds__(256)
    gemm_bf16_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ W, int ldw,
                     int M, int N, int K, Epilogue ep) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[2][kGemmBM * kGemmLds];
  __shared__ __align__(128) bf16 Bs[2][kGemmBN * kGemmLds];
  __shared__ __align__(128) float Cs[8][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int wm = warp >> 1, wn = warp & 1;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 chunks of 8
      const int chunk = tid + i * 256;
      const int r = chunk >> 2, c = (chunk & 3) * 8;
      const int gr = m0 + r, gk = k0 + c;
      const bool ok = gr < M && gk < K;
      cp_async16(&As[stage][r * kGemmLds + c], ok ? A + (size_t)gr * lda + gk : A, ok ? 16 : 0);
    }
    {  // W: 64 rows x 4 chunks of 8
      const int r = tid >> 2, c = (tid & 3) * 8;
      const int gn = n0 + r, gk = k0 + c;
      const bool ok = gn < N && gk < K;
      cp_async16(&Bs[stage][r * kGemmLds + c], ok ? W + (size_t)gn * ldw + gk : W, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + kGemmBK - 1) / kGemmBK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile(st ^ 1, (kt + 1) * kGemmBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[st][(wm * 32 + i * 16) * kGemmLds + kk], kGemmLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[st][(wn * 32 + j * 16) * kGemmLds + kk], kGemmLds);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * 32 + i * 16, c0 = n0 + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + (e >> 4), c = c0 + (e & 15);
        if (r < M && c < N) epilogue_store<bf16>(ep, r, c, cs[e]);
      }
      __syncwarp();
    }
}

// ----------------------------------------------------------------- f32 FMA

constexpr int kF32BM = 64, kF32BN = 64, kF32BK = 16;

// 256 threads in a 16x16 grid, 4x4 outputs each. Tiles are stored k-major
// in shared memory so the inner loop reads rows of 4 neighbouring outputs.
static __global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, int lda, const float* __restrict__ W, int ldw,
                    int M, int N, int K, Epilogue ep) {
  __shared__ float As[kF32BK][kF32BM + 4];
  __shared__ float Bs[kF32BK][kF32BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kF32BM, n0 = blockIdx.x * kF32BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int lr = tid >> 2, lc = (tid & 3) * 4;
  for (int k0 = 0; k0 < K; k0 += kF32BK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gk = k0 + lc + u;
      const int gr = m0 + lr, gn = n0 + lr;
      As[lc + u][lr] = (gr < M && gk < K) ? A[(size_t)gr * lda + gk] : 0.0f;
      Bs[lc + u][lr] = (gn < N && gk < K) ? W[(size_t)gn * ldw + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < M && c < N) epilogue_store<float>(ep, r, c, acc[i][j]);
    }
}

static inline int launch_gemm(const bf16* A, int lda, const bf16* W, int ldw, int M, int N,
                              int K, const Epilogue& ep, cudaStream_t st) {
  if (gemm_wgmma_takes(A, lda, W, ldw, N, K, ep))
    return gemm_wgmma_launch(A, lda, &W, ldw, &ep.bias, 1, M, N, K, ep, st);
  dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  gemm_bf16_kernel<<<grid, 256, 0, st>>>(A, lda, W, ldw, M, N, K, ep);
  SMM_CHECK_LAUNCH();
  return 0;
}

static inline int launch_gemm(const float* A, int lda, const float* W, int ldw, int M, int N,
                              int K, const Epilogue& ep, cudaStream_t st) {
  dim3 grid((N + kF32BN - 1) / kF32BN, (M + kF32BM - 1) / kF32BM);
  gemm_f32_kernel<<<grid, 256, 0, st>>>(A, lda, W, ldw, M, N, K, ep);
  SMM_CHECK_LAUNCH();
  return 0;
}

// The q|k|v projections of the attention blocks: three [E, K] weights and
// biases, outputs side by side in one packed [M, 3E] buffer (ldc = 3E). One
// launch of the wgmma kernel where it takes the shape, else three launches.
template <typename T>
static inline int launch_gemm_qkv(const T* A, int lda, const void* const* W, const void* const* bias,
                                  int M, int E, int K, void* out, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    const Epilogue ep{nullptr, nullptr, 0, out, 3 * E, ACT_NONE, 0};
    bool takes = true;
    for (int i = 0; i < 3; ++i) {
      Epilogue one = ep;
      one.bias = bias[i];
      takes = takes && gemm_wgmma_takes(A, lda, W[i], K, E, K, one);
    }
    if (takes)
      return gemm_wgmma_launch(A, lda, (const bf16* const*)W, K, bias, 3, M, E, K, ep, st);
  }
  for (int i = 0; i < 3; ++i) {
    const Epilogue ep{bias[i], nullptr, 0, (T*)out + i * E, 3 * E, ACT_NONE, 0};
    if (int e = launch_gemm(A, lda, (const T*)W[i], K, M, E, K, ep, st)) return e;
  }
  return 0;
}

// --------------------------------------------------------------- LayerNorm

// One warp per row, f32 statistics (two passes over the row, as the JAX
// reference computes mean((x - mu)^2)), output in the compute type.
template <typename TIn, typename T>
__global__ void __launch_bounds__(256)
    layernorm_kernel(const TIn* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                     T* __restrict__ y, int M, int E, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const TIn* xr = x + (size_t)row * E;
  float s = 0.0f;
  for (int c = lane; c < E; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / E;
  float v = 0.0f;
  for (int c = lane; c < E; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / E + eps);
  T* yr = y + (size_t)row * E;
  for (int c = lane; c < E; c += 32)
    yr[c] = from_f32<T>((to_f32(xr[c]) - mu) * rstd * to_f32(g[c]) + to_f32(b[c]));
}

template <typename TIn, typename T>
static inline int launch_layernorm(const TIn* x, const T* g, const T* b, T* y, int M, int E, float eps,
                            cudaStream_t st) {
  layernorm_kernel<TIn, T><<<(M + 7) / 8, 256, 0, st>>>(x, g, b, y, M, E, eps);
  SMM_CHECK_LAUNCH();
  return 0;
}

// ------------------------------------------------------ LayerNorm backward

// dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) [+ add], with
// dxhat = dy g and the statistics recomputed (two passes, f32), one warp
// per row. The scale and bias gradients (sums over rows of dy xhat and dy)
// are kept per block as [2, E] partials and summed over blocks in a fixed
// order by ln_grad_reduce_kernel, so the result does not vary from run to
// run as f32 atomics would. dx may alias dy (each lane reads its columns
// before it writes them).
constexpr int kLnBwdRows = 64;  // 4 warps x 16 rows; _build.LN_BWD_ROWS
constexpr int kLnMaxE = 1024;

template <typename T, typename TDy, typename TX, typename TAdd, typename TOut>
__global__ void __launch_bounds__(128)
    ln_bwd_kernel(const TDy* dy, const TX* x, const T* __restrict__ g, float eps, int M, int E,
                  const TAdd* add, TOut* dx, float* __restrict__ part) {
  __shared__ float red[4][2 * kLnMaxE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ag[kLnMaxE / 32], ab[kLnMaxE / 32];
#pragma unroll
  for (int i = 0; i < kLnMaxE / 32; ++i) ag[i] = ab[i] = 0.0f;
  for (int rr = 0; rr < kLnBwdRows / 4; ++rr) {
    const int row = blockIdx.x * kLnBwdRows + warp * (kLnBwdRows / 4) + rr;
    if (row >= M) break;
    const TX* xr = x + (size_t)row * E;
    const TDy* dr = dy + (size_t)row * E;
    float s = 0.0f;
    for (int c = lane; c < E; c += 32) s += to_f32(xr[c]);
    const float mu = warp_sum(s) / E;
    float v = 0.0f;
    for (int c = lane; c < E; c += 32) {
      const float d = to_f32(xr[c]) - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / E + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kLnMaxE / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < E) {
        const float xh = (to_f32(xr[c]) - mu) * rstd, d = to_f32(dr[c]);
        const float dh = d * to_f32(g[c]);
        s1 += dh;
        s2 += dh * xh;
        ag[i] += d * xh;
        ab[i] += d;
      }
    }
    s1 = warp_sum(s1) / E;
    s2 = warp_sum(s2) / E;
#pragma unroll
    for (int i = 0; i < kLnMaxE / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < E) {
        const float xh = (to_f32(xr[c]) - mu) * rstd;
        float o = rstd * (to_f32(dr[c]) * to_f32(g[c]) - s1 - xh * s2);
        if (add) o += to_f32(add[(size_t)row * E + c]);
        dx[(size_t)row * E + c] = from_f32<TOut>(o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLnMaxE / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < E) {
      red[warp][c] = ag[i];
      red[warp][E + c] = ab[i];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * E; j += blockDim.x)
    part[(size_t)blockIdx.x * 2 * E + j] = red[0][j] + red[1][j] + red[2][j] + red[3][j];
}

// dln[2, E] (scale grad, bias grad) = sum over blocks of the partials.
static __global__ void ln_grad_reduce_kernel(const float* __restrict__ part, int nblk, int E,
                                             float* __restrict__ dln) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * E) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * 2 * E + j];
  dln[j] = s;
}

template <typename T, typename TDy, typename TX, typename TAdd, typename TOut>
static inline int launch_ln_bwd(const TDy* dy, const TX* x, const T* g, float eps, int M, int E,
                                const TAdd* add, TOut* dx, float* part, float* dln,
                                cudaStream_t st) {
  if (E > kLnMaxE) return (int)cudaErrorInvalidValue;
  const int nblk = (M + kLnBwdRows - 1) / kLnBwdRows;
  ln_bwd_kernel<T, TDy, TX, TAdd, TOut><<<nblk, 128, 0, st>>>(dy, x, g, eps, M, E, add, dx, part);
  SMM_CHECK_LAUNCH();
  ln_grad_reduce_kernel<<<(2 * E + 255) / 256, 256, 0, st>>>(part, nblk, E, dln);
  SMM_CHECK_LAUNCH();
  return 0;
}

// ------------------------------------------------- FFN elementwise passes

// h = drop(gelu(hpre)) in the compute type: the forward's GEMM1 epilogue,
// replayed from the f32 pre-activation the backward keeps.
template <typename T>
__global__ void gelu_drop_kernel(const float* __restrict__ hpre, T* __restrict__ h, int M, int N,
                                 int act, Drop drop, int salt, int S) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / N), c = (int)(i % N);
    float v = apply_act(hpre[i], act);
    if (drop.seed)
      v = hash_keep((uint32_t)*drop.seed + (uint32_t)salt, r / S, r % S, c, drop.thresh)
              ? v * drop.scale : 0.0f;
    h[i] = from_f32<T>(v);
  }
}

// dst = drop(src) in the compute type (the output dropout's backward).
template <typename TIn, typename T>
__global__ void drop_cast_kernel(const TIn* __restrict__ src, T* __restrict__ dst, int M, int N,
                                 Drop drop, int salt, int S) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / N), c = (int)(i % N);
    float v = to_f32(src[i]);
    if (drop.seed)
      v = hash_keep((uint32_t)*drop.seed + (uint32_t)salt, r / S, r % S, c, drop.thresh)
              ? v * drop.scale : 0.0f;
    dst[i] = from_f32<T>(v);
  }
}

static inline int elementwise_grid(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

}  // namespace smm
