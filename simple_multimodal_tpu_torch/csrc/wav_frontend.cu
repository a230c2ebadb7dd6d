// Fused wav2vec2 front end for Hopper: conv_0 (K taps, stride s, 1 -> C
// channels, no bias) -> per-channel GroupNorm over time -> GELU, from the
// waveform [B, T] to frames [B, T1, C], T1 = (T - K) / s + 1, without the
// pre-norm activation ever reaching device memory.
//
// Replaces simple_multimodal_tpu/ops/pallas/wav_frontend.py: pass 1
// (`_stats_kernel` via `_fused_call`) and pass 2 (`_apply_kernel` via
// `_apply_call`). The TPU kernel frames 8 output frames into one 128-lane
// row and expands the weight to a banded [128, 8C] matrix so that a K = 10
// contraction fills a 128 x 128 matrix unit, and sums its statistics into a
// block revisited along a sequential grid axis. Neither carries over: a
// ten-tap contraction is ten FMAs per output here, and blocks run in no
// order.
//
// What bounds it on this card: bytes. The one output write is B T1 C
// elements (hundreds of MB at base width) against 2 K FLOP per element per
// pass, and GroupNorm needs whole-sequence statistics before any output, so
// the conv is computed twice from the small waveform instead of being
// stored: pass 1 writes per-block partial sums of y and y^2 per channel
// (folded outside in a fixed order, no atomics), pass 2 recomputes the
// tile, normalises, applies the affine and GELU (tanh form for bf16, erf
// for f32) and writes each output once with 16-byte stores. A block owns one
// batch row and 128 frames: it stages its waveform span in shared memory,
// each thread keeps the K x 8 weights of its eight channels in registers
// and walks the tile's frames. As in the TPU kernel, y is rounded through
// the compute type before the statistics and the normalisation, so both
// match the unfused composition, and the variance is sum(y^2)/n - mean^2
// clamped at 0.

#include "common.cuh"

namespace {

using namespace smm;

constexpr int kThreads = 256;
constexpr int kTile = 128;  // frames per block (ops/hopper/wav_frontend.py: WAV_TILE)

struct WavArgs {
  const void* wav;  // [B, T]
  const void* w;    // [K, C]
  int T, T1, C, stride;
};

template <typename T>
__device__ __forceinline__ float round_through(float y) {
  return to_f32(from_f32<T>(y));
}

// The block's waveform span into shared memory and the K x 8 weights of the
// thread's eight channels (from c0) into registers.
template <typename T, int K>
__device__ __forceinline__ void stage(const WavArgs& a, float* xs, float (&wr)[K][8], int c0) {
  const int t0 = blockIdx.x * kTile, b = blockIdx.y;
  const T* wav = (const T*)a.wav + (size_t)b * a.T;
  const int span = kTile * a.stride + K;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const long long idx = (long long)t0 * a.stride + i;
    xs[i] = idx < a.T ? to_f32(wav[idx]) : 0.0f;
  }
  const T* w = (const T*)a.w;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) wr[k][j] = to_f32(w[k * a.C + c0 + j]);
}

// y of frame f of the tile for the thread's eight channels, rounded through T.
template <typename T, int K>
__device__ __forceinline__ void conv_frame(const float* xs, const float (&wr)[K][8], int f,
                                           int stride, float (&y)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float x = xs[f * stride + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = fmaf(x, wr[k][j], y[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = round_through<T>(y[j]);
}

// Pass 1: part[b, block, 0|1, c] = sum over the block's valid frames of y, y^2.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) wav_stats_kernel(WavArgs a, float* part) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* red = smem + ((kTile * a.stride + K + 3) & ~3);  // [frame lanes][2][C]
  const int C = a.C, groups = C / 8, lanes = kThreads / groups;
  const int g = threadIdx.x % groups, fl = threadIdx.x / groups, c0 = g * 8;
  const int t0 = blockIdx.x * kTile;
  float wr[K][8];
  stage<T, K>(a, xs, wr, c0);
  __syncthreads();
  float s1[8], s2[8], y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.0f;
  for (int f = fl; f < kTile && t0 + f < a.T1; f += lanes) {
    conv_frame<T, K>(xs, wr, f, a.stride, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1[j] += y[j];
      s2[j] = fmaf(y[j], y[j], s2[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[(fl * 2 + 0) * C + c0 + j] = s1[j];
    red[(fl * 2 + 1) * C + c0 + j] = s2[j];
  }
  __syncthreads();
  float* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    float v = 0.0f;
    for (int l = 0; l < lanes; ++l) v += red[l * 2 * C + i];  // fixed order
    out[i] = v;
  }
}

// Pass 2: out[b, t, c] = gelu((y - mean) * rstd * gamma + beta).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    wav_apply_kernel(WavArgs a, const float* mean, const float* rstd, const float* gamma,
                     const float* beta, T* out, int act) {
  extern __shared__ float smem[];
  float* xs = smem;
  const int C = a.C, groups = C / 8, lanes = kThreads / groups;
  const int g = threadIdx.x % groups, fl = threadIdx.x / groups, c0 = g * 8;
  const int t0 = blockIdx.x * kTile, b = blockIdx.y;
  float wr[K][8];
  stage<T, K>(a, xs, wr, c0);
  float mu[8], sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mu[j] = mean[b * C + c0 + j];
    sc[j] = rstd[b * C + c0 + j] * gamma[c0 + j];
    sh[j] = beta[c0 + j];
  }
  __syncthreads();
  float y[8];
  for (int f = fl; f < kTile && t0 + f < a.T1; f += lanes) {
    conv_frame<T, K>(xs, wr, f, a.stride, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = apply_act((y[j] - mu[j]) * sc[j] + sh[j], act);
    T* o = out + ((size_t)b * a.T1 + t0 + f) * C + c0;
    if constexpr (sizeof(T) == 2) {
      __align__(16) __nv_bfloat162 h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
      *(uint4*)o = *(const uint4*)h;
    } else {
      *(float4*)o = make_float4(y[0], y[1], y[2], y[3]);
      *(float4*)(o + 4) = make_float4(y[4], y[5], y[6], y[7]);
    }
  }
}

// C = 8 * 2^n up to 2048, so that the 256 threads split into whole frame
// lanes of C / 8 channel groups; K = 10 is the one tap count instantiated.
bool shape_ok(int C, int K, int stride) {
  return K == 10 && stride >= 1 && C >= 8 && C <= 2048 && (C & (C - 1)) == 0;
}

size_t span_floats(int stride, int K) { return (size_t)((kTile * stride + K + 3) & ~3); }

}  // namespace

// dtype: 0 = f32, 1 = bf16 (of wav, w and out). wav [B, T]; w [K, C];
// part f32 [B, ceil(T1 / 128), 2, C]. Returns the first CUDA error, or 0.
extern "C" int smm_wav_frontend_stats(int dtype, const void* wav, const void* w, float* part,
                                      int B, int T, int T1, int C, int K, int stride,
                                      void* stream) {
  if (!shape_ok(C, K, stride)) return (int)cudaErrorInvalidValue;
  const WavArgs a{wav, w, T, T1, C, stride};
  const dim3 grid((T1 + kTile - 1) / kTile, B);
  const size_t bytes = sizeof(float) * (span_floats(stride, K) + (size_t)(kThreads / (C / 8)) * 2 * C);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    wav_stats_kernel<bf16, 10><<<grid, kThreads, bytes, st>>>(a, part);
  else
    wav_stats_kernel<float, 10><<<grid, kThreads, bytes, st>>>(a, part);
  SMM_CHECK_LAUNCH();
  return 0;
}

// mean, rstd f32 [B, C]; gamma, beta f32 [C]; out [B, T1, C] in the input
// type; the GELU is the tanh form for bf16 and erf for f32.
extern "C" int smm_wav_frontend_apply(int dtype, const void* wav, const void* w,
                                      const float* mean, const float* rstd, const float* gamma,
                                      const float* beta, void* out, int B, int T, int T1, int C,
                                      int K, int stride, void* stream) {
  if (!shape_ok(C, K, stride)) return (int)cudaErrorInvalidValue;
  const WavArgs a{wav, w, T, T1, C, stride};
  const dim3 grid((T1 + kTile - 1) / kTile, B);
  const size_t bytes = sizeof(float) * span_floats(stride, K);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    wav_apply_kernel<bf16, 10><<<grid, kThreads, bytes, st>>>(a, mean, rstd, gamma, beta,
                                                              (bf16*)out, ACT_GELU_TANH);
  else
    wav_apply_kernel<float, 10><<<grid, kThreads, bytes, st>>>(a, mean, rstd, gamma, beta,
                                                               (float*)out, ACT_GELU_ERF);
  SMM_CHECK_LAUNCH();
  return 0;
}
