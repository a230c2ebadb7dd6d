// Arguments shared by flash_attention.cu (forward) and
// flash_attention_bwd.cu (backward): softmax(q k^T / sqrt(D) + bias) v with
// separate query and key lengths.
//
// Three bodies serve them, picked from the element type and the head width
// alone: bf16 at D = 64, 96 and 128 runs the wgmma kernels
// (flash_attention_wgmma.cu, flash_attention_bwd_dq_wgmma.cu,
// flash_attention_bwd_dkv_wgmma.cu; their design is in
// flash_attention_wgmma.cuh), bf16 at D = 16 and 32 the WMMA bodies and f32
// or D = 4 and 8 the exact FMA bodies of flash_attention.cu and
// flash_attention_bwd.cu.
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

struct FlashOut {
  void* out;
  RowStrides so;
  float* m;  // [B, H, Sq] row maximum
  float* l;  // [B, H, Sq] sum of exp(s - m)
};

struct FlashBwdArgs {
  FlashArgs f;
  const void* out;
  const void* dout;
  RowStrides so, sdo;
  const float* m;  // [B, H, Sq] row maximum and sum from the forward
  const float* l;
  float* delta;    // [B, H, Sq]
  void* dq;
  void* dk;
  void* dv;
  RowStrides sdq, sdk, sddv;
  float* ds;  // [B, H, Sq, Sk] or null
};

// Head widths of the wgmma kernels (bf16 only). They read the bias with a
// key stride of 1 (bk is not consulted): the wrapper copies a bias whose
// key axis is strided or broadcast (ops/hopper/flash_attention.py).
constexpr bool flash_wgmma_width(int D) { return D == 64 || D == 96 || D == 128; }

// The wgmma kernels' launchers, one per source file; each returns the first
// CUDA error or 0. The backward pair expects delta already computed.
int flash_fwd_wgmma_launch(const FlashArgs& a, const FlashOut& w, int B, int D, cudaStream_t st);
int flash_bwd_dq_wgmma_launch(const FlashBwdArgs& a, int B, int D, cudaStream_t st);
int flash_bwd_dkv_wgmma_launch(const FlashBwdArgs& a, int B, int D, cudaStream_t st);
// attention_block's core at head widths 64 and 128: the forward kernel
// without a bias, with the hash dropout of the probabilities when drop.seed
// is set (attention_core_wgmma.cu); w.m and w.l may be null.
int attention_core_wgmma_launch(const FlashArgs& a, const FlashOut& w, const Drop& drop, int B,
                                int D, cudaStream_t st);
// attention_block's backward core at head widths 64 and 128: the backward
// pair without a bias, with the replayed hash dropout when drop.seed is set
// (attention_core_bwd_wgmma.cu); expects m, l and delta already computed.
int attention_core_bwd_wgmma_launch(const FlashBwdArgs& a, const Drop& drop, int B, int D,
                                    cudaStream_t st);
// Dynamic shared memory (bytes) each asks for at head width D (0: no kernel).
int flash_fwd_wgmma_smem(int D);
int flash_bwd_dq_wgmma_smem(int D);
int flash_bwd_dkv_wgmma_smem(int D);
int attention_core_wgmma_smem(int D);  // the dropout variant

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

// delta[b, h, s] = sum_d dout * out, one warp per (b, s, h) row.
template <typename T>
__global__ void flash_delta_kernel(FlashBwdArgs a, int B, int D) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int H = a.f.H, Sq = a.f.Sq;
  if (row >= B * Sq * H) return;
  const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
  const T* O = head_rows<T>(a.out, a.so, b, h, D) + (size_t)s * a.so.token;
  const T* G = head_rows<T>(a.dout, a.sdo, b, h, D) + (size_t)s * a.sdo.token;
  float d = 0.0f;
  for (int c = lane; c < D; c += 32) d += to_f32(O[c]) * to_f32(G[c]);
  d = warp_sum(d);
  if (lane == 0) a.delta[((size_t)b * H + h) * Sq + s] = d;
}

}  // namespace smm
