// Arguments shared by flash_attention.cu (forward) and
// flash_attention_bwd.cu (backward): softmax(q k^T / sqrt(D) + bias) v with
// separate query and key lengths.
//
// q, k, v, out and their gradients are [B, S, H, D] tensors read in place:
// each carries its batch and token strides (in elements), head h sits at
// column h * D of a token's row, and no [B, H, S, D] copy is made. The
// optional f32 bias is read through four strides, so an axis it broadcasts
// over has stride 0 and is never materialised.
#pragma once

#include "attention.cuh"

namespace smm {

struct RowStrides {
  long long batch, token;  // elements
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  RowStrides sq, sk, sv;
  const float* bias;       // null: none
  long long bb, bh, bq, bk;  // bias strides over (batch, head, query, key)
  int Sq, Sk, H;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_rows(const void* p, RowStrides s, int b, int h, int D) {
  return (const T*)p + (size_t)b * s.batch + h * D;
}

template <typename T>
__device__ __forceinline__ T* head_rows(void* p, RowStrides s, int b, int h, int D) {
  return (T*)p + (size_t)b * s.batch + h * D;
}

// The scaled, biased score of (q, k), or -inf for a key past Sk (weight 0).
// Rows past Sq are computed on zero queries and never stored.
__device__ __forceinline__ float flash_score(const FlashArgs& a, float qk, int b, int h, int q,
                                             int k) {
  if (k >= a.Sk) return -INFINITY;
  float s = qk * a.scale;
  if (a.bias && q < a.Sq) s += a.bias[b * a.bb + h * a.bh + q * a.bq + k * a.bk];
  return s;
}

}  // namespace smm
