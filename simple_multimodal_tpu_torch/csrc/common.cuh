// Shared device helpers for the port's Hopper kernels: element-type
// conversion, the GELU epilogues and warp reductions. Every kernel computes
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

enum Act { ACT_NONE = 0, ACT_GELU_ERF = 1, ACT_GELU_TANH = 2 };

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
