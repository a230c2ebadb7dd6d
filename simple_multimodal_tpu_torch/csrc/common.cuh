// Shared device helpers for the port's Hopper kernels: element-type
// conversion, the GELU epilogues and their derivatives, the stateless
// dropout hash and warp reductions. Every kernel computes
// in f32 and converts at load and store, so one template serves bf16 and
// f32 inputs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace smm {

typedef __nv_bfloat16 bf16;

// Fill for masked keys: a finite value, as the TPU kernels use, so a row
// whose keys are all masked attends uniformly instead of producing NaN.
constexpr float kMaskFill = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// ACT_DGELU_*: multiply by the GELU derivative at a pre-activation the
// epilogue reads beside the product (the FFN backward's dh epilogue).
enum Act {
  ACT_NONE = 0,
  ACT_GELU_ERF = 1,
  ACT_GELU_TANH = 2,
  ACT_DGELU_ERF = 3,
  ACT_DGELU_TANH = 4
};

// erf-exact GELU for f32 and the tanh form for bf16, as the JAX package's
// ops/attention.gelu picks them.
__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_GELU_ERF) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  if (act == ACT_GELU_TANH) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v;
}

// d/dx of apply_act's two GELU forms (act = the forward's ACT_GELU_*).
__device__ __forceinline__ float gelu_grad(float x, int act) {
  if (act == ACT_GELU_ERF)
    return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) +
           x * 0.3989422804014327f * expf(-0.5f * x * x);
  const float c = 0.7978845608028654f;
  const float t = tanhf(c * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
}

// Stateless dropout: the murmur3 finalizer of (seed, head, q, k), as
// `_hash_keep` in simple_multimodal_tpu/ops/pallas/deberta_attention.py
// computes it; keep iff the hash >= thresh = rate * 2^32. The forward and
// backward kernels regenerate the same mask from the same indices.
__device__ __forceinline__ bool hash_keep(uint32_t seed, uint32_t head, uint32_t q, uint32_t k,
                                          uint32_t thresh) {
  uint32_t x = q * 0x9E3779B9u + k * 0x85EBCA6Bu;
  x = x + head * 0xC2B2AE35u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// Dropout of one call: `seed` points at the int32 seed in device memory
// (null: no dropout); scale = 1 / (1 - rate).
struct Drop {
  const int* seed;
  uint32_t thresh;
  float scale;
};

// Salts of the FFN's two dropout sites (ops/hopper/dropout.py).
constexpr int kSaltMid = 1, kSaltOut = 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace smm

#define SMM_CHECK_LAUNCH()                 \
  do {                                     \
    cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
