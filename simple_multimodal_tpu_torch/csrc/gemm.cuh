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

// ------------------------------------------------ row kernels with partials

// The row kernels that leave per-block column partials (the LayerNorm
// backward, drop_cast_sum_kernel) cut the M rows into contiguous blocks of
// rows_per_block rows: as many blocks as two of 256 threads on each of 132
// SMs, fewer when M is short, so the partials number a few hundred whatever
// M is and fold_columns_kernel reads them in a fixed order. Warp w of a
// block takes its rows w, w + 8, ... _build.row_partition mirrors this.
constexpr int kRowBlocks = 264;
constexpr int kRowWarps = 8;
constexpr int kLnMaxE = 1024;

inline int rows_per_block(int M) {
  const int want = (M + kRowWarps - 1) / kRowWarps;
  const int blocks = want < kRowBlocks ? want : kRowBlocks;
  return blocks > 0 ? (M + blocks - 1) / blocks : 1;
}
inline int row_blocks(int M) { return M > 0 ? (M + rows_per_block(M) - 1) / rows_per_block(M) : 0; }

// 8 consecutive elements (16 bytes of bf16, 32 of f32) as f32, and back.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// A block's per-column sums of its eight warps, added in warp order, to
// out[0, E): acc[i][j] is column 8 (lane + 32 i) + j of this warp.
template <int NC>
__device__ __forceinline__ void block_column_sums(const float (&acc)[NC][8], int E, float* out) {
  __shared__ float red[kRowWarps][kLnMaxE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + 32 * i;
    if (8 * c < E)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][8 * c + j] = acc[i][j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < E; j += blockDim.x) {
    float s = red[0][j];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) s += red[w][j];
    out[j] = s;
  }
  __syncthreads();
}

// out[c] = sum over r < rows of part[r * cols + c], in a fixed order: warp w
// of a block sums the w-th eighth of the rows in row order, then the eight
// sums are added in warp order. One block per 32 columns, whose lanes read
// neighbouring columns. Run to run the same bits, as f32 atomics would not be.
static __global__ void __launch_bounds__(256)
    fold_columns_kernel(const float* __restrict__ part, int rows, int cols,
                        float* __restrict__ out) {
  __shared__ float red[kRowWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = blockIdx.x * 32 + lane;
  const int lo = rows * warp / kRowWarps, hi = rows * (warp + 1) / kRowWarps;
  float s = 0.0f;
  if (c < cols)
#pragma unroll 4
    for (int r = lo; r < hi; ++r) s += part[(size_t)r * cols + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) t += red[w][lane];
    out[c] = t;
  }
}

static inline int launch_fold_columns(const float* part, int rows, int cols, float* out,
                                      cudaStream_t st) {
  fold_columns_kernel<<<(cols + 31) / 32, 256, 0, st>>>(part, rows, cols, out);
  SMM_CHECK_LAUNCH();
  return 0;
}

// ------------------------------------------------------ LayerNorm backward

// dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) [+ add], with
// dxhat = dy g and the statistics recomputed (two passes over the row, f32,
// as the JAX reference computes mean((x - mu)^2)). The scale and bias
// gradients (sums over rows of dy xhat and dy) are per-block [2, E]
// partials, folded over blocks by fold_columns_kernel in a fixed order.
//
// What bounds it: bytes (dy, x and add read once, dx written once: 364 MB
// at the ViT site [47 280, 768], 0.11 ms at 3.35 TB/s). The design: one
// warp per row with the row in registers (lane l holds the 8-column chunks
// l, l + 32, ..., NC of them: 24 values a lane at E = 768), loaded once with
// 16-byte loads, so the row is read once; the column sums stay in
// registers across a warp's rows; 256-thread blocks own contiguous row
// ranges (rows_per_block), so the partials number at most 264; two blocks
// an SM up to E = 768, one above. dx may alias
// dy or x: a warp reads its whole row before it writes it.
template <typename T, typename TDy, typename TX, typename TAdd, typename TOut, int NC>
__global__ void __launch_bounds__(256, NC < 4 ? 2 : 1)  // E > 768: 128 registers would spill
    ln_bwd_rows_kernel(const TDy* dy, const TX* x, const T* __restrict__ g, float eps, int M,
                       int E, int rpb, const TAdd* add, TOut* dx, float* __restrict__ part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ag[NC][8], ab[NC][8];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) ag[i][j] = ab[i][j] = 0.0f;
  const int r0 = (int)blockIdx.x * rpb, r_end = min(r0 + rpb, M);
  for (int row = r0 + warp; row < r_end; row += kRowWarps) {
    const size_t o = (size_t)row * E;
    float xv[NC][8], dv[NC][8];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 8 * (lane + 32 * i);
      if (c < E) {
        load8(x + o + c, xv[i]);
        load8(dy + o + c, dv[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[i][j] = dv[i][j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s += xv[i][j];
    }
    const float mu = warp_sum(s) / E;
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (8 * (lane + 32 * i) < E)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xv[i][j] -= mu;
          v += xv[i][j] * xv[i][j];
        }
    const float rstd = rsqrtf(warp_sum(v) / E + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 8 * (lane + 32 * i);
      if (c < E) {
        float gv[8];
        load8(g + c, gv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = xv[i][j] * rstd, d = dv[i][j], dh = d * gv[j];
          xv[i][j] = xh;
          s1 += dh;
          s2 += dh * xh;
          ag[i][j] += d * xh;
          ab[i][j] += d;
        }
      }
    }
    s1 = warp_sum(s1) / E;
    s2 = warp_sum(s2) / E;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 8 * (lane + 32 * i);
      if (c < E) {
        float gv[8], av[8], out[8];
        load8(g + c, gv);
        if (add) load8(add + o + c, av);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          out[j] = rstd * (dv[i][j] * gv[j] - s1 - xv[i][j] * s2);
          if (add) out[j] += av[j];
        }
        store8(dx + o + c, out);
      }
    }
  }
  float* mine = part + (size_t)blockIdx.x * 2 * E;
  block_column_sums<NC>(ag, E, mine);
  block_column_sums<NC>(ab, E, mine + E);
}

template <typename T, typename TDy, typename TX, typename TAdd, typename TOut, int NC>
static inline void launch_ln_bwd_nc(const TDy* dy, const TX* x, const T* g, float eps, int M,
                                    int E, const TAdd* add, TOut* dx, float* part,
                                    cudaStream_t st) {
  ln_bwd_rows_kernel<T, TDy, TX, TAdd, TOut, NC>
      <<<row_blocks(M), 256, 0, st>>>(dy, x, g, eps, M, E, rows_per_block(M), add, dx, part);
}

// The LayerNorm backward and its fold into dln[2, E] (scale grad, bias
// grad). part: f32 [row_blocks(M), 2E]. E a multiple of 8, at most 1024, and
// every row 16-byte aligned (the wrappers align the bases).
template <typename T, typename TDy, typename TX, typename TAdd, typename TOut>
static inline int launch_ln_bwd(const TDy* dy, const TX* x, const T* g, float eps, int M, int E,
                                const TAdd* add, TOut* dx, float* part, float* dln,
                                cudaStream_t st) {
  if (E > kLnMaxE || E % 8) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    switch ((E + 255) / 256) {
      case 1: launch_ln_bwd_nc<T, TDy, TX, TAdd, TOut, 1>(dy, x, g, eps, M, E, add, dx, part, st); break;
      case 2: launch_ln_bwd_nc<T, TDy, TX, TAdd, TOut, 2>(dy, x, g, eps, M, E, add, dx, part, st); break;
      case 3: launch_ln_bwd_nc<T, TDy, TX, TAdd, TOut, 3>(dy, x, g, eps, M, E, add, dx, part, st); break;
      default: launch_ln_bwd_nc<T, TDy, TX, TAdd, TOut, 4>(dy, x, g, eps, M, E, add, dx, part, st);
    }
    SMM_CHECK_LAUNCH();
  }
  return launch_fold_columns(part, row_blocks(M), 2 * E, dln, st);
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

// dst = drop(src) in bf16 (the output dropout's backward: dy0) and the
// per-block column sums of the dropped f32 values (db2's partials, [row
// blocks, E]), folded into db2 [E] in a fixed order. The row partition and
// the 16-byte row chunks of the LayerNorm backward; E a multiple of 8, at
// most 1024.
template <typename TIn, int NC>
__global__ void __launch_bounds__(256)
    drop_cast_sum_kernel(const TIn* __restrict__ src, bf16* __restrict__ dst, int M, int E,
                         int rpb, Drop drop, int salt, int S, float* __restrict__ part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t seed = drop.seed ? (uint32_t)*drop.seed + (uint32_t)salt : 0u;
  float acc[NC][8];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int r0 = (int)blockIdx.x * rpb, r_end = min(r0 + rpb, M);
  for (int row = r0 + warp; row < r_end; row += kRowWarps) {
    const size_t o = (size_t)row * E;
    const uint32_t hr = drop.seed ? hash_row(seed, row / S, row % S) : 0u;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = 8 * (lane + 32 * i);
      if (c < E) {
        float v[8];
        load8(src + o + c, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (drop.seed) v[j] = hash_row_keep(hr, c + j, drop.thresh) ? v[j] * drop.scale : 0.0f;
          acc[i][j] += v[j];
        }
        store8(dst + o + c, v);
      }
    }
  }
  block_column_sums<NC>(acc, E, part + (size_t)blockIdx.x * E);
}

template <typename TIn>
static inline int launch_drop_cast_sum(const TIn* src, bf16* dst, int M, int E, Drop drop,
                                       int salt, int S, float* part, float* sum,
                                       cudaStream_t st) {
  if (E > kLnMaxE || E % 8) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    const dim3 grid(row_blocks(M));
    const int rpb = rows_per_block(M);
    switch ((E + 255) / 256) {
      case 1: drop_cast_sum_kernel<TIn, 1><<<grid, 256, 0, st>>>(src, dst, M, E, rpb, drop, salt, S, part); break;
      case 2: drop_cast_sum_kernel<TIn, 2><<<grid, 256, 0, st>>>(src, dst, M, E, rpb, drop, salt, S, part); break;
      case 3: drop_cast_sum_kernel<TIn, 3><<<grid, 256, 0, st>>>(src, dst, M, E, rpb, drop, salt, S, part); break;
      default: drop_cast_sum_kernel<TIn, 4><<<grid, 256, 0, st>>>(src, dst, M, E, rpb, drop, salt, S, part);
    }
    SMM_CHECK_LAUNCH();
  }
  return launch_fold_columns(part, row_blocks(M), E, sum, st);
}

static inline int elementwise_grid(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

}  // namespace smm
