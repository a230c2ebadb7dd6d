// wav2vec2's positional convolution: a grouped 'same' 1-D convolution over
// NWC frames, y[b, t, g·Cg + n] = bias[g·Cg + n] +
//   Σ_k Σ_c x[b, t + k − pad, g·Cg + c] · W_k[g][n][c],   t in [0, L),
// with frames outside [0, L) read as zeros. The forward runs it with
// pad = K / 2 (which drops the trailing extra frame of an even K, as the
// model's SamePad does) and the weight as given; the input gradient runs it
// on dy with pad = K − 1 − K / 2 and W'_k = W_{K−1−k}ᵀ per group, a layout
// the wrapper makes (ops/hopper/pos_conv.py).
//
// It replaces no TPU kernel: the JAX package leaves this convolution to XLA
// (simple_multimodal_tpu/models/wav2vec2.py, PositionalConvEmbedding:
// lax.conv_general_dilated with feature_group_count = G). It was added
// because cuDNN's input gradient of the layer (dgrad_engine, one launch a
// group) took 72 ms of a 10 s B=8 train step and 133 ms of a 20 s one on an
// H100, the largest device cost of both, for 3.77e10 operations a product at
// 10 s.
//
// What bounds it on this card: operations. One product at [8, 499, 768],
// K = 128, 16 groups of 48 channels is 3.77e10 operations, 38 us at 989
// TFLOP/s, and 76 us at [8, 999, 768]; the bytes (x, y and the 9.4 MB
// weight) take 7 us at 3.35 TB/s. The depth of each group's product is only
// 48 channels, so the work is many thin products: one [rows x 48] · [48 x 48]
// per tap.
//
// What the design does about it:
// - Implicit GEMM per (row tile, clip, group): D[rows x P] += A_k · W_k over
//   the taps, A_k being the staged input rows shifted by k. A block owns
//   128 · MT output rows; each of its two consumer warpgroups issues, for
//   every tap, m64nPk16 wgmma over its MT tiles of 64 rows, the accumulator
//   in f32 registers, and writes each output element once (no atomics: dx
//   is bit-equal between runs).
// - The input rows a window of taps needs (rows + taps − 1 frames of the
//   group's Cg channels) are staged once per block by all its threads with
//   plain 16-byte loads, zeros outside the clip and in the padding channels.
//   They are stored in wgmma's no-swizzle layout, each 8-channel chunk a
//   column of 16-byte rows: a core matrix is then 128 contiguous bytes
//   wherever it starts, so the row shift of tap k is 16·k bytes added to the
//   descriptor's address, and A is read from shared memory by the tensor
//   cores with no register copy and no ldmatrix.
// - The weights stream through a ring of stages (a few taps, ~18 KB, each),
//   one bulk copy a stage from a producer warp, in the same no-swizzle
//   layout, prepared by the wrapper ([G][K][P/8][P][8]), so the copy is
//   contiguous and needs no tensor map.
// - One tap a step: its products are one committed group, with one group in
//   flight behind it; a stage is released once its last tap's products have
//   completed; the warps reconverge (__syncwarp) after the barrier wait and
//   the release, as in gemm_wgmma.cu. With a stage's taps in a loop nested
//   inside the stage loop ptxas serialized the products (C7520).
// - The group width Cg (any multiple of 8 up to 128) is padded to the wgmma
//   width P in {16, 32, 48, 64, 96, 128}: zero weights and zero input chunks,
//   the padding columns never stored. Blocks of one group are neighbours in
//   launch order, so its weights are read from L2.
// - f32 runs an exact FMA body (pos_conv_f32_kernel) for the 1e-3 checks.
// What still bounds it: every block streams its group's whole weight (K · P
// · P · 2 bytes, 590 KB at the base width) from L2 for 128 · MT rows, and
// the thin products read both operands from shared memory (PERF.md has the
// times).

#include "common.cuh"
#include "hopper.cuh"

namespace smm {
namespace {

namespace hp = smm::hopper;

constexpr int kConsumers = 256;         // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxWindow = 128;         // taps a staged input window covers at most
constexpr int kStages = 4;
constexpr int kStageTarget = 18432;     // bytes a stage holds at most (unless one tap is more)
constexpr int kSmemPerSM = 233472;      // 228 KB: shared memory of an SM, 1 KB a block reserved

constexpr int taps_per_stage(int P) {
  int t = 1;
  while (2 * t * P * P * 2 <= kStageTarget) t *= 2;
  return t;
}

// The layout of a block's dynamic shared memory for group width P and MT
// 64-row tiles a warpgroup.
template <int P, int MT>
struct Plan {
  static constexpr int rows = 128 * MT;                   // output rows of a block
  static constexpr int tap_bytes = P * P * 2;
  static constexpr int taps = taps_per_stage(P);           // taps a stage
  static constexpr int stage_bytes = taps * tap_bytes;
  static constexpr int window = kMaxWindow / taps * taps;  // whole stages a window
  static constexpr int in_rows = (rows + window - 1 + 7) / 8 * 8;
  static constexpr int in_bytes = (in_rows * P * 2 + 1023) / 1024 * 1024;
  static constexpr int bars = in_bytes + kStages * stage_bytes;  // full[], then empty[]
  static constexpr int bytes = bars + 16 * kStages + 1024;
  static constexpr int blocks_per_sm = 2 * (bytes + 1024) <= kSmemPerSM ? 2 : 1;
};

struct ConvArgs {
  const void* x;      // [B, L, E] in the compute type
  const void* w;      // [G, K, P/8, P, 8] in the compute type
  const float* bias;  // [E] or null
  void* y;            // [B, L, E]
  int L, E, Cg, K, pad;
};

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int P, int MT>
__global__ void __launch_bounds__(kThreads, Plan<P, MT>::blocks_per_sm)
    pos_conv_wgmma_kernel(const ConvArgs a) {
  using PL = Plan<P, MT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t in_s = hp::smem_u32(hp::align_1024(smem_raw));
  const uint32_t ring = in_s + PL::in_bytes;
  const uint32_t full = in_s + PL::bars, empty = full + 8 * kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * PL::rows, b = blockIdx.y, g = blockIdx.z;
  const int K = a.K;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, kConsumers / 32);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  const bool producer = warp == kConsumers / 32;
  const int wgi = warp >> 2;  // consumer warpgroup: rows [wgi · 64 · MT, (wgi + 1) · 64 · MT)
  const bf16* xb = (const bf16*)a.x + (size_t)b * a.L * a.E + g * a.Cg;
  const bf16* wg = (const bf16*)a.w + (size_t)g * K * P * P;
  float acc[MT][P / 2];
  for (int k0 = 0; k0 < K; k0 += PL::window) {
    const int kw = min(PL::window, K - k0);
    const int rows = PL::rows + kw - 1, cells = rows * (P / 8);
    if (k0 > 0) __syncthreads();  // every product of the last window has completed
    // the whole block stages frames t0 + k0 − pad + i, i < rows: chunk j of row i at
    // in_s + j·in_rows·16 + i·16, zeros outside the clip and past the group's channels
    const int f0 = t0 + k0 - a.pad, chunks = a.Cg / 8;
    for (int c0 = 0; c0 < cells; c0 += kThreads) {
      const int idx = c0 + threadIdx.x, j = idx / rows, i = idx - j * rows, f = f0 + i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (idx < cells && j < chunks && f >= 0 && f < a.L)
        v = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)f * a.E + 8 * j));
      if (idx < cells)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         in_s + j * PL::in_rows * 16 + i * 16),
                     "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                     : "memory");
    }
    fence_async_smem();
    __syncthreads();
    if (producer) {  // one thread streams the window's taps through the ring (whole stages)
      if (lane == 0)
        for (int l = k0 / PL::taps; l < (k0 + kw + PL::taps - 1) / PL::taps; ++l) {
          const int s = l % kStages;
          if (l >= kStages) hp::mbar_wait(empty + 8 * s, (l / kStages - 1) & 1);
          const int taps = min(PL::taps, K - l * PL::taps);
          hp::mbar_arrive_expect_tx(full + 8 * s, taps * PL::tap_bytes);
          hp::bulk_load(ring + s * PL::stage_bytes, wg + (size_t)l * PL::taps * P * P,
                        taps * PL::tap_bytes, full + 8 * s);
        }
      continue;
    }
    // one tap a step: its products in one group, one group in flight behind it
    for (int k = k0; k < k0 + kw; ++k) {
      const int l = k / PL::taps, s = l % kStages;
      hp::mbar_wait(full + 8 * s, (l / kStages) & 1);  // at once after the stage's first tap
      __syncwarp();
      const uint32_t wt = ring + s * PL::stage_bytes + (k - l * PL::taps) * PL::tap_bytes;
      const int row = wgi * 64 * MT + k - k0;  // the tap's shifted first row
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        const uint64_t db = hp::desc_interleave(wt + 2 * ks * P * 16, P * 16, 128);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint64_t da = hp::desc_interleave(
              in_s + 2 * ks * PL::in_rows * 16 + (row + 64 * m) * 16, PL::in_rows * 16, 128);
          hp::wgmma_ss<P, 0>(acc[m], da, db, (k | ks) != 0);
        }
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // tap k − 1's products are done
      if (k > k0 && k % PL::taps == 0 && lane == 0)  // and with them its whole stage
        hp::mbar_arrive(empty + 8 * ((l - 1) % kStages));
      __syncwarp();
    }
    hp::wgmma_wait<0>();  // the window's last stage, and the staged rows, are free
    if (lane == 0) hp::mbar_arrive(empty + 8 * ((k0 + kw - 1) / PL::taps % kStages));
  }
  if (producer) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) hp::fence_regs(acc[m]);

  // epilogue: this thread's two rows of each tile and its column pair of every 8-column block
  const int lc = (lane & 3) * 2;
  bf16* yb = (bf16*)a.y + (size_t)b * a.L * a.E + g * a.Cg;
  const float* bias = a.bias ? a.bias + g * a.Cg : nullptr;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = t0 + wgi * 64 * MT + m * 64 + (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
    for (int jb = 0; jb < P / 8; ++jb) {
      const int n = 8 * jb + lc;
      if (n >= a.Cg) continue;
      float2 bv = make_float2(0.0f, 0.0f);
      if (bias) bv = *reinterpret_cast<const float2*>(bias + n);
      if (r0 < a.L)
        *reinterpret_cast<uint32_t*>(yb + (size_t)r0 * a.E + n) =
            hp::pack_bf16(acc[m][4 * jb] + bv.x, acc[m][4 * jb + 1] + bv.y);
      if (r1 < a.L)
        *reinterpret_cast<uint32_t*>(yb + (size_t)r1 * a.E + n) =
            hp::pack_bf16(acc[m][4 * jb + 2] + bv.x, acc[m][4 * jb + 3] + bv.y);
    }
  }
}

// f32: an exact FMA body. A block owns 64 output rows of one (clip, group);
// thread i computes outputs i, i + 256, ... of the [64][Cg] tile, over the
// taps in order and, inside a tap, the channels in order.
constexpr int kF32Rows = 64, kF32Threads = 256, kF32Outs = 64 * 128 / kF32Threads;
constexpr int kF32Window = 128;

__global__ void __launch_bounds__(kF32Threads) pos_conv_f32_kernel(const ConvArgs a, int P) {
  extern __shared__ float xs[];  // [rows][Cg]
  const int t0 = blockIdx.x * kF32Rows, b = blockIdx.y, g = blockIdx.z, Cg = a.Cg;
  const float* xb = (const float*)a.x + (size_t)b * a.L * a.E + g * Cg;
  const float* wg = (const float*)a.w + (size_t)g * a.K * P * P;
  const int outs = kF32Rows * Cg;
  int xo[kF32Outs], wo[kF32Outs];
  float acc[kF32Outs];
#pragma unroll
  for (int j = 0; j < kF32Outs; ++j) {
    const int o = threadIdx.x + j * kF32Threads, r = o / Cg, n = o - r * Cg;
    xo[j] = r * Cg, wo[j] = n * 8, acc[j] = 0.0f;
  }
  for (int k0 = 0; k0 < a.K; k0 += kF32Window) {
    const int kw = min(kF32Window, a.K - k0), rows = kF32Rows + kw - 1, f0 = t0 + k0 - a.pad;
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * Cg; idx += kF32Threads) {
      const int i = idx / Cg, c = idx - i * Cg, f = f0 + i;
      xs[idx] = f >= 0 && f < a.L ? xb[(size_t)f * a.E + c] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kw; ++kk) {
      const float* wt = wg + (size_t)(k0 + kk) * P * P;
      const float* xk = xs + kk * Cg;
      for (int c = 0; c < Cg; ++c) {
        const float* wc = wt + (c >> 3) * P * 8 + (c & 7);
#pragma unroll
        for (int j = 0; j < kF32Outs; ++j)
          if (threadIdx.x + j * kF32Threads < outs)
            acc[j] = fmaf(xk[xo[j] + c], __ldg(wc + wo[j]), acc[j]);
      }
    }
  }
  float* yb = (float*)a.y + (size_t)b * a.L * a.E + g * Cg;
#pragma unroll
  for (int j = 0; j < kF32Outs; ++j) {
    const int o = threadIdx.x + j * kF32Threads;
    if (o >= outs) continue;
    const int r = o / Cg, n = o - r * Cg, t = t0 + r;
    if (t < a.L) yb[(size_t)t * a.E + n] = acc[j] + (a.bias ? a.bias[g * Cg + n] : 0.0f);
  }
}

// 64-row tiles a warpgroup: two (256 rows a block) while the accumulators
// stay small, one at the widest groups.
constexpr int tiles_for(int P) { return P <= 64 ? 2 : 1; }

template <int P>
int launch_wgmma(const ConvArgs& a, int B, int G, cudaStream_t st) {
  constexpr int MT = tiles_for(P);
  using PL = Plan<P, MT>;
  static const int allowed = (int)cudaFuncSetAttribute(
      pos_conv_wgmma_kernel<P, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, PL::bytes);
  if (allowed != 0) return allowed;
  const dim3 grid((a.L + PL::rows - 1) / PL::rows, B, G);
  pos_conv_wgmma_kernel<P, MT><<<grid, kThreads, PL::bytes, st>>>(a);
  SMM_CHECK_LAUNCH();
  return 0;
}

int f32_smem(int Cg) { return (kF32Rows + kF32Window - 1) * Cg * 4; }

int launch_f32(const ConvArgs& a, int B, int G, int P, cudaStream_t st) {
  static const int allowed = (int)cudaFuncSetAttribute(
      pos_conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f32_smem(128));
  if (allowed != 0) return allowed;
  const dim3 grid((a.L + kF32Rows - 1) / kF32Rows, B, G);
  pos_conv_f32_kernel<<<grid, kF32Threads, f32_smem(a.Cg), st>>>(a, P);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace smm

using namespace smm;

// The wgmma width a group of cg channels is padded to: the least of 16, 32,
// 48, 64, 96, 128 that holds it, or 0 (cg not a multiple of 8, or above 128).
extern "C" int smm_pos_conv_width(int cg) {
  if (cg < 8 || cg > 128 || cg % 8) return 0;
  const int widths[] = {16, 32, 48, 64, 96, 128};
  for (int p : widths)
    if (cg <= p) return p;
  return 0;
}

// Dynamic shared memory of the wgmma kernel at width P (0 for another P).
extern "C" int smm_pos_conv_smem(int P) {
  switch (P) {
    case 16: return Plan<16, tiles_for(16)>::bytes;
    case 32: return Plan<32, tiles_for(32)>::bytes;
    case 48: return Plan<48, tiles_for(48)>::bytes;
    case 64: return Plan<64, tiles_for(64)>::bytes;
    case 96: return Plan<96, tiles_for(96)>::bytes;
    case 128: return Plan<128, tiles_for(128)>::bytes;
    default: return 0;
  }
}

// y [B, L, E] = the grouped 'same' convolution of x [B, L, E] (contiguous,
// 16-byte aligned) with w [G, K, P/8, P, 8] (P = smm_pos_conv_width(E / G),
// zero past E / G), plus bias [E] (f32, or null): y[t] = bias + Σ_k x[t + k −
// pad] · W_k. dtype 1: bf16 x, w, y on wgmma; 0: f32 on exact FMAs. Returns
// the first CUDA error, or 0.
extern "C" int smm_pos_conv(int dtype, const void* x, const void* w, const float* bias, void* y,
                            int B, int L, int E, int G, int K, int pad, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (G <= 0 || E % G || K <= 0) return (int)cudaErrorInvalidValue;
  const int Cg = E / G, P = smm_pos_conv_width(Cg);
  if (!P) return (int)cudaErrorInvalidValue;
  const ConvArgs a{x, w, bias, y, L, E, Cg, K, pad};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_f32(a, B, G, P, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (P) {
    case 16: return launch_wgmma<16>(a, B, G, st);
    case 32: return launch_wgmma<32>(a, B, G, st);
    case 48: return launch_wgmma<48>(a, B, G, st);
    case 64: return launch_wgmma<64>(a, B, G, st);
    case 96: return launch_wgmma<96>(a, B, G, st);
    default: return launch_wgmma<128>(a, B, G, st);
  }
}
