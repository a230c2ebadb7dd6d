// Fused wav2vec2 front end for Hopper: conv_0 (K = 10 taps, stride s <= 5,
// 1 -> C channels, no bias) -> per-channel GroupNorm over time -> GELU, from
// the waveform [B, T] to frames [B, T1, C], T1 = (T - K) / s + 1, without
// the pre-norm activation ever reaching device memory; and its backward.
//
// Replaces simple_multimodal_tpu/ops/pallas/wav_frontend.py: pass 1
// (`_stats_kernel` via `_fused_call`), pass 2 (`_apply_kernel` via
// `_apply_call`) and the custom VJP `_frontend_bwd` (jax.vjp of
// `_xla_reference`, which has no Pallas kernel). The TPU kernel frames 8
// output frames into one 128-lane row and expands the weight to a banded
// [128, 8C] matrix so that a K = 10 contraction fills a 128 x 128 matrix
// unit, and sums its statistics into a block revisited along a sequential
// grid axis. Neither carries over: here the conv is a product of
// [frames, 16] x [16, C] on mma.sync.m16n8k16 (bf16 in, f32 out; row t of A
// is the 16 samples from t*s, B the [10, C] weight padded with zero taps),
// and blocks run in no order, so every cross-block sum is a per-block
// partial folded afterwards by one small kernel in a fixed order.
//
// What bounds it on this card: bytes. The output is B T1 C elements (262 MB
// in bf16 at [8, 160000], C = 512) against 2 K FLOP per element per pass,
// and GroupNorm needs whole-sequence statistics before any output, so the
// conv is computed again from the 5 MB waveform instead of being stored.
// The backward reads the cotangent, as large, twice. Design:
// - A persistent grid: blockIdx.y is the batch row, and block x of nb walks
//   that row's 128-frame tiles x, x + nb, ... (nb from
//   ops/hopper/wav_frontend.py::row_blocks, two 256-thread blocks an SM).
//   The weights are staged once per block. The waveform span of the next
//   tile lands in shared memory by cp.async while the current one is
//   computed, and is rounded to the compute type at the tile's end (two
//   buffers, one __syncthreads a tile).
// - A warp job is 16 frames x 64 channels: one A fragment from the span in
//   shared memory, eight m16n8k16 products against the warp's B fragments
//   (in registers in the forward, in shared memory in the backward, whose
//   registers hold the sums). y is rounded through the compute type before
//   anything reads it, as the TPU kernel does.
// - Pass 1 sums y and y^2 per channel in registers over all the block's
//   tiles and leaves one partial per block; wav_fold_stats_kernel folds
//   them into mean, rstd, rstd*gamma and beta - mean*rstd*gamma per (b, c)
//   (variance sum(y^2)/n - mean^2 clamped at 0, as the JAX kernel), so no
//   torch operation runs between the passes.
// - Pass 2 normalises with that scale and shift (each thread's 16
//   channels' in registers), applies the GELU (tanh form on one MUFU
//   tanh.approx for bf16, erf for f32) and writes each output once, through
//   a per-warp shared tile as 16-byte row stores. The feature encoder reads
//   these NWC frames as a channels-last [B, C, 1, T1] tensor: cuDNN's convs
//   run NHWC here, so no layout suits conv_1 better.
// - Backward, with xhat = (y - mean) rstd, z = gamma xhat + beta, dz = g
//   gelu'(z): pass A leaves per-block partials of sum dz and sum dz xhat;
//   wav_fold_dz_kernel turns them into dbeta, dgamma and, per (b, c),
//   rstd gamma and the two means; pass B forms dy = rstd gamma (dz - mean dz
//   - xhat mean(dz xhat)), rounds it to the compute type (as autograd of the
//   bf16 conv does) and accumulates dkernel = X^T dy on the tensor cores:
//   movmatrix.trans turns dy's accumulator fragments into the B operand, A
//   is X^T read from the span. Each warp copies the cotangent of its next
//   job into shared memory by cp.async while it computes the current one
//   and reads it in accumulator order with ldmatrix. Where asked, dwav =
//   dy W^T on the tensor cores too (dy's accumulators are already its A
//   operand); the per-frame columns are overlap-added per tile in a fixed
//   order and the K - s samples a tile shares with the next are added by
//   wav_fold_dx_kernel.
// - f32 runs the same structure with exact FMA bodies (the 1e-3 checks).
// Every sum is taken in a fixed order, so two runs give the same bits.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace smm;
using smm::hopper::pack_bf16;
using smm::hopper::smem_u32;

constexpr int kThreads = 256, kWarps = 8;
constexpr int kTile = 128;  // frames per tile (ops/hopper/wav_frontend.py: WAV_TILE)
constexpr int kSub = 16;    // frames of one warp job: the M of one m16n8k16 product
constexpr int kSlice = 64;  // channels of one warp job: eight n8 column tiles
constexpr int kTaps = 10;   // K, the one tap count built
constexpr int kMaxC = 512;  // eight slices, one for each warp
constexpr int kMaxStride = 5;
constexpr int kPre = 3;     // samples a thread stages per tile: ceil((128 * 5 + 10) / 256)

struct Geo {
  const float* wav;  // [B, T]
  const void* w;    // [K, C] in the compute type
  int B, T, T1, C, stride, ntiles, nb;
};

// Byte offsets of one pass's dynamic shared memory (pass 0 stats, 1 apply,
// 2 backward sums, 3 backward gradients): the next tile's span in f32 as
// cp.async lands it, the spans in the compute type (two buffers), the
// weights in f32, per-channel constants (float4 each), the cross-warp sums,
// a per-warp [16][64] staging tile (the output in pass 1; two buffers of the
// cotangent in the bf16 backward passes, dy in f32 pass 3), for dwav the
// per-frame columns of every slice, and the B fragments of the bf16
// backward passes. At 256 threads, C = 512 and stride 5 every pass but f32
// pass 3 fits two blocks an SM.
struct Lay {
  int span, span_pad, Cp, nsl, pitch, xr, xs, ws, vec, red, stage, dx, frag, bytes;
};

__host__ __device__ inline Lay layout(int tb, int stride, int C, int pass, bool dwav) {
  Lay L;
  L.span = kTile * stride + kTaps;
  L.span_pad = (L.span + 7) & ~7;
  L.Cp = C < kSlice ? kSlice : C;
  L.nsl = L.Cp / kSlice;
  L.pitch = kSlice + 16 / tb;  // a staged row: 16 bytes of padding
  const int nvec = pass == 1 ? 1 : pass == 2 ? 1 : pass == 3 ? 2 : 0;  // float4s a channel
  const int rows = pass == 3 ? kTaps : pass == 1 ? 0 : 2;
  const int stages = pass == 1 ? 1 : (pass >= 2 && tb == 2) ? 2 : (pass == 3 ? 1 : 0);
  int off = 0;
  L.xr = off;  // the next tile's span as cp.async leaves it, f32
  off += L.span_pad * 4;
  L.xs = off;
  off += 2 * L.span_pad * tb;
  L.ws = off;
  off += kTaps * L.Cp * 4;
  L.vec = off;
  off += nvec * L.Cp * 16;
  // the staging tiles are done with before the cross-warp sums, which the
  // backward passes keep in the same bytes
  const int red_bytes = kWarps * rows * kSlice * 4;
  const int stage_bytes = stages * kWarps * kSub * L.pitch * tb;
  L.red = off;
  if (pass >= 2) {
    L.stage = off;
    off += red_bytes > stage_bytes ? red_bytes : stage_bytes;
  } else {
    off += red_bytes;
    L.stage = off;
    off += stage_bytes;
  }
  L.dx = off;
  off += dwav ? L.nsl * kTile * kTaps * 4 : 0;
  L.frag = off;  // bf16 backward passes: each warp's B fragments, [8][32] uint2
  off += (pass >= 2 && tb == 2) ? kWarps * 8 * 32 * 8 : 0;
  L.bytes = off;
  return L;
}

// The four outputs of one accumulator fragment rounded to the compute type
// and back to f32 (bf16: two packed conversions).
template <typename T>
__device__ __forceinline__ void round4(const float (&d)[4], float (&y)[4]);

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

template <>
__device__ __forceinline__ void round4<float>(const float (&d)[4], float (&y)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = d[i];
}

template <>
__device__ __forceinline__ void round4<bf16>(const float (&d)[4], float (&y)[4]) {
  const float2 a = unpack2(pack_bf16(d[0], d[1])), b = unpack2(pack_bf16(d[2], d[3]));
  y[0] = a.x;
  y[1] = a.y;
  y[2] = b.x;
  y[3] = b.y;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8 x 8 bf16 tile a warp holds in accumulator order (lane 4g + q: row
// g, columns 2q, 2q + 1), transposed: the lane then holds row g of the
// transpose, i.e. elements (2q, g) and (2q + 1, g).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(x));
  return r;
}

// Two 8 x 8 bf16 tiles from shared memory in accumulator order; lane l < 16
// gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n"); }

// The tanh GELU and its derivative on one MUFU op (tanh.approx, relative
// error ~2^-11, below the bf16 rounding of what it feeds); f32 keeps
// common.cuh's erf forms.
__device__ __forceinline__ float tanh_approx(float x) {
  float r;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

template <typename T>
__device__ __forceinline__ float gelu_t(float v) {
  if constexpr (sizeof(T) == 2) {
    const float h = 0.5f * v;
    return fmaf(h, tanh_approx(v * fmaf(0.0356774081f, v * v, 0.7978845608f)), h);
  } else {
    return apply_act(v, ACT_GELU_ERF);
  }
}

template <typename T>
__device__ __forceinline__ float gelu_grad_t(float x) {
  if constexpr (sizeof(T) == 2) {
    const float x2 = x * x;
    const float t = tanh_approx(x * fmaf(0.0356774081f, x2, 0.7978845608f));
    return fmaf(0.5f * x * fmaf(-t, t, 1.0f), fmaf(0.1070322243f, x2, 0.7978845608f),
                fmaf(0.5f, t, 0.5f));
  } else {
    return gelu_grad(x, ACT_GELU_ERF);
  }
}

// A warp's place: its 64-channel slice and the 16-frame sub-tiles of each
// tile it computes (all eight when C = 512, one slice a warp).
struct Warp {
  int warp, lane, g, q, nsl, slice, c0, sub0, step;
  __device__ explicit Warp(int nslices) {
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    q = lane & 3;
    nsl = nslices;
    slice = warp % nsl;
    c0 = slice * kSlice;
    sub0 = warp / nsl;
    step = kWarps / nsl;
  }
};

// The waveform span of `tile` into the f32 staging buffer with cp.async
// (zero past T; the caller commits)...
__device__ __forceinline__ void span_issue(const Geo& a, int b, int tile, int span, float* xr) {
  const long long base = (long long)tile * kTile * a.stride;
  const float* row = a.wav + (size_t)b * a.T;
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < span) {
      if (base + idx < a.T)
        cp_async4(xr + idx, row + base + idx);
      else
        xr[idx] = 0.0f;
    }
  }
}

// ... and, once it has landed, into the tile buffer rounded to the compute
// type: each thread converts the elements it copied, so no barrier is needed
// before this.
template <typename T>
__device__ __forceinline__ void span_finish(const float* xr, T* xb, int span) {
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < span) xb[idx] = from_f32<T>(xr[idx]);
  }
}

// Per-block set-up shared by the four passes: the weights into shared
// memory in f32 (zero for the padding channels c >= C), the first tile's
// span into buffer 0 (the caller synchronises).
template <typename T>
__device__ __forceinline__ void begin(const Geo& a, const Lay& L, unsigned char* smem, int b) {
  float* ws = (float*)(smem + L.ws);
  for (int i = threadIdx.x; i < kTaps * L.Cp; i += kThreads) {
    const int k = i / L.Cp, c = i % L.Cp;
    ws[i] = c < a.C ? to_f32(((const T*)a.w)[k * a.C + c]) : 0.0f;
  }
  float* xr = (float*)(smem + L.xr);
  span_issue(a, b, blockIdx.x, L.span, xr);
  cp_async_commit();
  cp_async_wait0();
  span_finish<T>(xr, (T*)(smem + L.xs), L.span);
}

// One warp job's conv: epi(j, d) gets, for column tile j, d[0], d[1] = frame
// g, channels c0 + 8j + 2q, +1 and d[2], d[3] = frame g + 8, the same.
// bf16 keeps the warp's B fragments (its slice of the padded [16, C]
// weight) in registers, or, with kSmemB (the backward passes, which need
// the registers), in shared memory, one 8-byte load a product.
template <typename T, bool kSmemB = false>
struct Conv;

template <bool kSmemB>
struct Conv<bf16, kSmemB> {
  uint32_t bw[kSmemB ? 1 : 8][2];
  const uint2* bs;
  __device__ __forceinline__ void init(const float* ws, int Cp, const Warp& w, uint2* frag) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = w.c0 + 8 * j + w.g;
      const uint32_t b0 = pack_bf16(ws[2 * w.q * Cp + n], ws[(2 * w.q + 1) * Cp + n]);
      const uint32_t b1 = w.q == 0 ? pack_bf16(ws[8 * Cp + n], ws[9 * Cp + n]) : 0u;  // taps 8, 9
      if constexpr (kSmemB) {
        frag[(w.warp * 8 + j) * 32 + w.lane] = make_uint2(b0, b1);
      } else {
        bw[j][0] = b0;
        bw[j][1] = b1;
      }
    }
    bs = frag + w.warp * 8 * 32 + w.lane;
  }
  template <class F>
  __device__ __forceinline__ void run(const bf16* xb, const float*, int, int f0, int s,
                                      const Warp& w, F&& epi) const {
    const bf16* r0 = xb + (f0 + w.g) * s + 2 * w.q;
    const bf16* r1 = r0 + 8 * s;
    uint32_t a[4];
    a[0] = pack2(r0[0], r0[1]);
    a[1] = pack2(r1[0], r1[1]);
    a[2] = w.q == 0 ? pack2(r0[8], r0[9]) : 0u;
    a[3] = w.q == 0 ? pack2(r1[8], r1[9]) : 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (kSmemB) {
        const uint2 bj = bs[j * 32];
        mma16816(d, a, bj.x, bj.y);
      } else {
        mma16816(d, a, bw[j][0], bw[j][1]);
      }
      epi(j, d);
    }
  }
};

template <bool kSmemB>
struct Conv<float, kSmemB> {
  __device__ __forceinline__ void init(const float*, int, const Warp&, uint2*) {}
  template <class F>
  __device__ __forceinline__ void run(const float* xb, const float* ws, int Cp, int f0, int s,
                                      const Warp& w, F&& epi) const {
    float x0[kTaps], x1[kTaps];
    const float* r0 = xb + (f0 + w.g) * s;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      x0[k] = r0[k];
      x1[k] = r0[8 * s + k];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* wc = ws + w.c0 + 8 * j + 2 * w.q;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float2 v = *(const float2*)(wc + k * Cp);
        d[0] = fmaf(x0[k], v.x, d[0]);
        d[1] = fmaf(x0[k], v.y, d[1]);
        d[2] = fmaf(x1[k], v.x, d[2]);
        d[3] = fmaf(x1[k], v.y, d[3]);
      }
      epi(j, d);
      asm volatile("" ::: "memory");  // one column tile's weights live at a time
    }
  }
};

// Rows r < R of v[r][j][e] (this thread's sums over its frames, channel
// c0 + 8j + 2q + e) summed over the warp's eight frame lanes, then over the
// warps of each slice in warp order, into dst[r * C + c].
template <int R>
__device__ __forceinline__ void write_row_sums(float (&v)[R][8][2], float* red, const Warp& w,
                                               int C, int Cp, float* dst) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = v[r][j][e];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (w.g == 0) red[(w.warp * R + r) * kSlice + 8 * j + 2 * w.q + e] = x;
      }
  __syncthreads();
  for (int i = threadIdx.x; i < R * Cp; i += kThreads) {
    const int r = i / Cp, c = i % Cp;
    if (c >= C) continue;
    float s = 0.0f;
    for (int wi = c / kSlice; wi < kWarps; wi += w.nsl)
      s += red[(wi * R + r) * kSlice + c % kSlice];
    dst[r * C + c] = s;
  }
}

// ------------------------------------------------------------------ pass 1

// part[b, blockIdx.x, 0|1, c] = sum over the block's valid frames of y, y^2.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) wav_stats_kernel(Geo a, float* part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay L = layout(sizeof(T), a.stride, a.C, 0, false);
  const Warp w(L.nsl);
  const int b = blockIdx.y, s = a.stride;
  const float* ws = (const float*)(smem + L.ws);
  T* xs = (T*)(smem + L.xs);
  float* xr = (float*)(smem + L.xr);
  begin<T>(a, L, smem, b);
  __syncthreads();
  Conv<T> conv;
  conv.init(ws, L.Cp, w, nullptr);
  float v[2][8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[0][j][0] = v[0][j][1] = v[1][j][0] = v[1][j][1] = 0.0f;
  int it = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += a.nb, ++it) {
    const int next = tile + a.nb;
    if (next < a.ntiles) span_issue(a, b, next, L.span, xr);
    cp_async_commit();
    const T* xb = xs + (it & 1) * L.span_pad;
    const int t0 = tile * kTile;
    for (int sub = w.sub0; sub < kTile / kSub; sub += w.step) {
      const int f0 = sub * kSub;
      const bool v0 = t0 + f0 + w.g < a.T1, v1 = t0 + f0 + w.g + 8 < a.T1;
      conv.run(xb, ws, L.Cp, f0, s, w, [&](int j, float(&d)[4]) {
        float y[4];
        round4<T>(d, y);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y0 = v0 ? y[e] : 0.0f;
          const float y1 = v1 ? y[2 + e] : 0.0f;
          v[0][j][e] += y0 + y1;
          v[1][j][e] = fmaf(y1, y1, fmaf(y0, y0, v[1][j][e]));
        }
      });
    }
    cp_async_wait0();
    if (next < a.ntiles) span_finish<T>(xr, xs + ((it + 1) & 1) * L.span_pad, L.span);
    __syncthreads();
  }
  write_row_sums<2>(v, (float*)(smem + L.red), w, a.C, L.Cp,
                    part + (size_t)(b * a.nb + blockIdx.x) * 2 * a.C);
}

// coef [4, B, C] = mean, rstd, rstd * gamma, beta - mean * rstd * gamma: the
// blocks' partials of each (b, c) in block order.
__global__ void wav_fold_stats_kernel(const float* part, const float* gamma, const float* beta,
                                      float* coef, int B, int C, int nb, int T1, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  const float* p = part + (size_t)b * nb * 2 * C + c;
  float s1 = 0.0f, s2 = 0.0f;
  for (int k = 0; k < nb; ++k) {
    s1 += p[(size_t)k * 2 * C];
    s2 += p[(size_t)k * 2 * C + C];
  }
  const float n = (float)T1, mean = s1 / n;
  const float rstd = rsqrtf(fmaxf(s2 / n - mean * mean, 0.0f) + eps);
  const float scale = rstd * gamma[c];
  const size_t BC = (size_t)B * C;
  coef[i] = mean;
  coef[BC + i] = rstd;
  coef[2 * BC + i] = scale;
  coef[3 * BC + i] = beta[c] - mean * scale;
}

// ------------------------------------------------------------------ pass 2

// out [B, T1, C] = gelu(y * scale + shift).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) wav_apply_kernel(Geo a, const float* coef, T* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay L = layout(sizeof(T), a.stride, a.C, 1, false);
  const Warp w(L.nsl);
  const int b = blockIdx.y, s = a.stride, C = a.C, Cp = L.Cp;
  const float* ws = (const float*)(smem + L.ws);
  float2* vec = (float2*)(smem + L.vec);  // (scale, shift) per channel
  T* xs = (T*)(smem + L.xs);
  T* st = (T*)(smem + L.stage) + w.warp * kSub * L.pitch;
  for (int i = threadIdx.x; i < Cp; i += kThreads) {
    const size_t BC = (size_t)a.B * C, bc = (size_t)b * C + i;
    vec[i] = i < C ? make_float2(coef[2 * BC + bc], coef[3 * BC + bc]) : make_float2(0.0f, 0.0f);
  }
  float* xr = (float*)(smem + L.xr);
  begin<T>(a, L, smem, b);
  __syncthreads();
  Conv<T> conv;
  conv.init(ws, Cp, w, nullptr);
  float2 ss[8][2];  // the thread's 16 channels' (scale, shift), for the whole block
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) ss[j][e] = vec[w.c0 + 8 * j + 2 * w.q + e];
  int it = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += a.nb, ++it) {
    const int next = tile + a.nb;
    if (next < a.ntiles) span_issue(a, b, next, L.span, xr);
    cp_async_commit();
    const T* xb = xs + (it & 1) * L.span_pad;
    const int t0 = tile * kTile;
    for (int sub = w.sub0; sub < kTile / kSub; sub += w.step) {
      const int f0 = sub * kSub;
      conv.run(xb, ws, Cp, f0, s, w, [&](int j, float(&d)[4]) {
        float o[4];
        round4<T>(d, o);
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = gelu_t<T>(fmaf(o[i], ss[j][i & 1].x, ss[j][i & 1].y));
        const int col = 8 * j + 2 * w.q;
        if constexpr (sizeof(T) == 2) {
          *(uint32_t*)(st + w.g * L.pitch + col) = pack_bf16(o[0], o[1]);
          *(uint32_t*)(st + (w.g + 8) * L.pitch + col) = pack_bf16(o[2], o[3]);
        } else {
          *(float2*)(st + w.g * L.pitch + col) = make_float2(o[0], o[1]);
          *(float2*)(st + (w.g + 8) * L.pitch + col) = make_float2(o[2], o[3]);
        }
      });
      __syncwarp();
      constexpr int V = 16 / sizeof(T), CH = kSlice / V;  // 16-byte chunks of a row
#pragma unroll
      for (int i = w.lane; i < kSub * CH; i += 32) {
        const int r = i / CH, ch = i % CH, c = w.c0 + ch * V, t = t0 + f0 + r;
        if (t < a.T1 && c < C)
          *(uint4*)(out + ((size_t)b * a.T1 + t) * C + c) =
              *(const uint4*)(st + r * L.pitch + ch * V);
      }
      __syncwarp();
    }
    cp_async_wait0();
    if (next < a.ntiles) span_finish<T>(xr, xs + ((it + 1) & 1) * L.span_pad, L.span);
    __syncthreads();
  }
}

// ------------------------------------------------------------- backward

// The backward passes walk the same jobs as the forward; in bf16 each warp
// copies the cotangent of its next job ([16 frames][64 channels]) into
// shared memory with cp.async while it computes the current one, and reads
// it in accumulator order with ldmatrix.
struct Jobs {
  int tile, sub;
  __device__ __forceinline__ void next(const Warp& w, int nb) {
    sub += w.step;
    if (sub >= kTile / kSub) {
      sub = w.sub0;
      tile += nb;
    }
  }
};

template <typename T>
__device__ __forceinline__ void gy_prefetch(const Geo& a, const T* gy, int b, int tile, int sub,
                                            const Warp& w, T* buf, int pitch) {
  if constexpr (sizeof(T) == 2) {
    const int t0 = tile * kTile + sub * kSub;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = w.lane + 32 * k, r = i / 8, c = w.c0 + (i % 8) * 8;
      T* dst = buf + r * pitch + (i % 8) * 8;
      if (tile < a.ntiles && t0 + r < a.T1 && c < a.C)
        cp_async16(dst, gy + ((size_t)b * a.T1 + t0 + r) * a.C + c);
      else
        *(uint4*)dst = make_uint4(0u, 0u, 0u, 0u);  // no NaN from stale bits past T1 or C
    }
    cp_async_commit();
  }
}

// The cotangent of channels (n, n + 1) at frames g and g + 8 of the job:
// bf16 from the staged tile (ldmatrix), f32 straight from device memory.
template <typename T>
struct GyTile {
  __device__ __forceinline__ void get(int j, const T* buf, int pitch, const Warp& w, const Geo& a,
                                      const T* gy, int b, int t0, float2 (&gv)[2]) {
    if constexpr (sizeof(T) == 2) {
      uint32_t r[2];
      ldsm_x2(r, buf + (w.lane & 15) * pitch + 8 * j);
      gv[0] = unpack2(r[0]);
      gv[1] = unpack2(r[1]);
    } else {
      const int n = w.c0 + 8 * j + 2 * w.q;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = t0 + w.g + 8 * rr;
        gv[rr] = (t < a.T1 && n < a.C) ? *(const float2*)(gy + ((size_t)b * a.T1 + t) * a.C + n)
                                       : make_float2(0.0f, 0.0f);
      }
    }
  }
};

// Per channel (rstd, -mean rstd, gamma, beta) into vec[0, Cp).
__device__ __forceinline__ void stage_norm(const Geo& a, int b, int Cp, const float* coef,
                                           const float* gamma, const float* beta, float4* vec) {
  const size_t BC = (size_t)a.B * a.C;
  for (int i = threadIdx.x; i < Cp; i += kThreads) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < a.C) {
      const float mean = coef[(size_t)b * a.C + i], rstd = coef[BC + (size_t)b * a.C + i];
      v = make_float4(rstd, -mean * rstd, gamma[i], beta[i]);
    }
    vec[i] = v;
  }
}

// dz = g gelu'(z) and xhat at one output (0 past T1), from y (rounded),
// the cotangent and the channel's constants.
template <typename T>
__device__ __forceinline__ void dz_at(float y, float g, const float4& k, bool valid, float& dz,
                                      float& xh) {
  xh = fmaf(y, k.x, k.y);
  dz = valid ? g * gelu_grad_t<T>(fmaf(k.z, xh, k.w)) : 0.0f;
}

// Pass A: part[b, blockIdx.x, 0|1, c] = sums over the block's frames of dz
// and dz * xhat.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    wav_bwd_sums_kernel(Geo a, const float* coef, const float* gamma, const float* beta,
                        const T* gy, float* part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lay L = layout(sizeof(T), a.stride, a.C, 2, false);
  const Warp w(L.nsl);
  const int b = blockIdx.y, s = a.stride, Cp = L.Cp;
  const float* ws = (const float*)(smem + L.ws);
  const float4* vec = (const float4*)(smem + L.vec);
  T* xs = (T*)(smem + L.xs);
  T* gbuf = (T*)(smem + L.stage) + w.warp * 2 * kSub * L.pitch;  // bf16: two buffers a warp
  stage_norm(a, b, Cp, coef, gamma, beta, (float4*)(smem + L.vec));
  Jobs job{(int)blockIdx.x, w.sub0};
  gy_prefetch<T>(a, gy, b, job.tile, job.sub, w, gbuf, L.pitch);
  float* xr = (float*)(smem + L.xr);
  begin<T>(a, L, smem, b);
  __syncthreads();
  Conv<T, true> conv;
  conv.init(ws, Cp, w, (uint2*)(smem + L.frag));  // each lane reads back what it wrote
  float v[2][8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[0][j][0] = v[0][j][1] = v[1][j][0] = v[1][j][1] = 0.0f;
  int it = 0, k = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += a.nb, ++it) {
    const int next = tile + a.nb;
    const T* xb = xs + (it & 1) * L.span_pad;
    const int t0 = tile * kTile;
    for (int sub = w.sub0; sub < kTile / kSub; sub += w.step, ++k) {
      const int f0 = sub * kSub;
      Jobs nj = job;
      nj.next(w, a.nb);
      gy_prefetch<T>(a, gy, b, nj.tile, nj.sub, w, gbuf + ((k + 1) & 1) * kSub * L.pitch, L.pitch);
      job = nj;
      if constexpr (sizeof(T) == 2) cp_async_wait1();
      __syncwarp();
      if (sub == w.sub0 && next < a.ntiles) {  // behind the first job's cotangent
        span_issue(a, b, next, L.span, xr);
        cp_async_commit();
      }
      const T* cur = gbuf + (k & 1) * kSub * L.pitch;
      const bool v0 = t0 + f0 + w.g < a.T1, v1 = t0 + f0 + w.g + 8 < a.T1;
      GyTile<T> gt;
      conv.run(xb, ws, Cp, f0, s, w, [&](int j, float(&d)[4]) {
        float2 gv[2];
        gt.get(j, cur, L.pitch, w, a, gy, b, t0 + f0, gv);
        const int n = w.c0 + 8 * j + 2 * w.q;
        float y[4];
        round4<T>(d, y);
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // one channel's constants live at a time
          const float4 kc = vec[n + e];
          float dz0, xh0, dz1, xh1;
          dz_at<T>(y[e], e ? gv[0].y : gv[0].x, kc, v0, dz0, xh0);
          dz_at<T>(y[2 + e], e ? gv[1].y : gv[1].x, kc, v1, dz1, xh1);
          v[0][j][e] += dz0 + dz1;
          v[1][j][e] = fmaf(dz1, xh1, fmaf(dz0, xh0, v[1][j][e]));
        }
      });
      __syncwarp();
    }
    cp_async_wait0();
    if (next < a.ntiles) span_finish<T>(xr, xs + ((it + 1) & 1) * L.span_pad, L.span);
    __syncthreads();
  }
  write_row_sums<2>(v, (float*)(smem + L.red), w, a.C, Cp,
                    part + (size_t)(b * a.nb + blockIdx.x) * 2 * a.C);
}

// The partials of pass A: co [3, B, C] = rstd * gamma, mean dz, mean dz xhat
// per (b, c); dgb [2, C] = dgamma, dbeta. A block takes 32 channels; its
// eight thread rows take batch rows r, r + 8, ... and are added in row order.
__global__ void __launch_bounds__(kThreads)
    wav_fold_dz_kernel(const float* part, const float* coef, const float* gamma, float* co,
                       float* dgb, int B, int C, int nb, int T1) {
  __shared__ float red[8][2][32];
  const int cl = threadIdx.x % 32, r = threadIdx.x / 32, c = blockIdx.x * 32 + cl;
  const size_t BC = (size_t)B * C;
  const float n = (float)T1;
  float dg = 0.0f, db = 0.0f;
  if (c < C) {
    for (int b = r; b < B; b += 8) {
      const float* p = part + (size_t)b * nb * 2 * C + c;
      float s1 = 0.0f, s2 = 0.0f;
      for (int k = 0; k < nb; ++k) {
        s1 += p[(size_t)k * 2 * C];
        s2 += p[(size_t)k * 2 * C + C];
      }
      const size_t i = (size_t)b * C + c;
      co[i] = coef[BC + i] * gamma[c];
      co[BC + i] = s1 / n;
      co[2 * BC + i] = s2 / n;
      dg += s2;
      db += s1;
    }
  }
  red[r][0][cl] = dg;
  red[r][1][cl] = db;
  __syncthreads();
  if (r == 0 && c < C) {
    for (int k = 1; k < 8; ++k) {
      dg += red[k][0][cl];
      db += red[k][1][cl];
    }
    dgb[c] = dg;
    dgb[C + c] = db;
  }
}

// Pass B: part[b, blockIdx.x, k, c] = sum over the block's frames of
// dy[t, c] * x[t s + k]; with DWAV also dxt[b, tile, i] = the tile's own
// frames' share of dwav at sample tile * 128 s + i.
template <typename T, bool DWAV>
__global__ void __launch_bounds__(kThreads, DWAV || sizeof(T) == 4 ? 1 : 2)
    wav_bwd_grads_kernel(Geo a, const float* coef, const float* gamma, const float* beta,
                         const float* co, const T* gy, float* part, float* dxt) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf = sizeof(T) == 2;
  const Lay L = layout(sizeof(T), a.stride, a.C, 3, DWAV);
  const Warp w(L.nsl);
  const int b = blockIdx.y, s = a.stride, Cp = L.Cp;
  const float* ws = (const float*)(smem + L.ws);
  // per channel (rstd, -mean rstd, gamma, beta), then (rstd gamma, -rstd gamma m1,
  // -rstd gamma m2, 0)
  const float4* vec = (const float4*)(smem + L.vec);
  float* red = (float*)(smem + L.red);
  float* dxs = (float*)(smem + L.dx);  // [slice][frame of the tile][tap]
  T* xs = (T*)(smem + L.xs);
  T* gbuf = (T*)(smem + L.stage) + w.warp * (kBf ? 2 : 1) * kSub * L.pitch;
  stage_norm(a, b, Cp, coef, gamma, beta, (float4*)(smem + L.vec));
  for (int i = threadIdx.x; i < Cp; i += kThreads) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < a.C) {
      const size_t BC = (size_t)a.B * a.C, bc = (size_t)b * a.C + i;
      const float am = co[bc];
      v = make_float4(am, -am * co[BC + bc], -am * co[2 * BC + bc], 0.0f);
    }
    ((float4*)(smem + L.vec))[Cp + i] = v;
  }
  Jobs job{(int)blockIdx.x, w.sub0};
  gy_prefetch<T>(a, gy, b, job.tile, job.sub, w, gbuf, L.pitch);
  float* xr = (float*)(smem + L.xr);
  begin<T>(a, L, smem, b);
  __syncthreads();
  Conv<T, true> conv;
  conv.init(ws, Cp, w, (uint2*)(smem + L.frag));  // each lane reads back what it wrote
  // bf16: dw[j] = (tap g | g + 8, channel c0 + 8j + 2q, +1) in accumulator
  // order; f32: dw[k][e] = (tap k, channel c0 + 2 lane + e)
  float dw[kBf ? 8 : kTaps][kBf ? 4 : 2];
#pragma unroll
  for (int i = 0; i < (kBf ? 8 : kTaps); ++i)
#pragma unroll
    for (int e = 0; e < (kBf ? 4 : 2); ++e) dw[i][e] = 0.0f;
  uint32_t wt[4][2][2];  // DWAV, bf16: W^T as the B operand, k = 16 channels, n = 8 taps
  if constexpr (DWAV && kBf) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int tap = 8 * nt + w.g, cc = w.c0 + 16 * m + 2 * w.q;
        const float* wr = ws + (tap < kTaps ? tap : 0) * Cp + cc;
        wt[m][nt][0] = tap < kTaps ? pack_bf16(wr[0], wr[1]) : 0u;
        wt[m][nt][1] = tap < kTaps ? pack_bf16(wr[8], wr[9]) : 0u;
      }
  }
  int it = 0, k = 0;
  for (int tile = blockIdx.x; tile < a.ntiles; tile += a.nb, ++it) {
    const int next = tile + a.nb;
    const T* xb = xs + (it & 1) * L.span_pad;
    const int t0 = tile * kTile;
    for (int sub = w.sub0; sub < kTile / kSub; sub += w.step, ++k) {
      const int f0 = sub * kSub;
      Jobs nj = job;
      nj.next(w, a.nb);
      gy_prefetch<T>(a, gy, b, nj.tile, nj.sub, w, gbuf + ((k + 1) & 1) * kSub * L.pitch, L.pitch);
      job = nj;
      if constexpr (kBf) cp_async_wait1();
      __syncwarp();
      if (sub == w.sub0 && next < a.ntiles) {  // behind the first job's cotangent
        span_issue(a, b, next, L.span, xr);
        cp_async_commit();
      }
      const T* cur = kBf ? gbuf + (k & 1) * kSub * L.pitch : gbuf;
      T* dys = gbuf;  // f32: the job's dy, [16][64]
      const bool v0 = t0 + f0 + w.g < a.T1, v1 = t0 + f0 + w.g + 8 < a.T1;
      uint32_t ax[4] = {0u, 0u, 0u, 0u};  // X^T: m = tap, k = frame
      uint32_t top[8], bot[8];
      if constexpr (kBf) {
        const bf16* xr = (const bf16*)xb + (f0 + 2 * w.q) * s + w.g;
        ax[0] = pack2(xr[0], xr[s]);
        ax[2] = pack2(xr[8 * s], xr[9 * s]);
        if (w.g < 2) {
          ax[1] = pack2(xr[8], xr[s + 8]);
          ax[3] = pack2(xr[8 * s + 8], xr[9 * s + 8]);
        }
      }
      GyTile<T> gt;
      conv.run(xb, ws, Cp, f0, s, w, [&](int j, float(&d)[4]) {
        float2 gv[2];
        gt.get(j, cur, L.pitch, w, a, gy, b, t0 + f0, gv);
        const int n = w.c0 + 8 * j + 2 * w.q;
        const float4 k0 = vec[n], k1 = vec[n + 1], m0 = vec[Cp + n], m1 = vec[Cp + n + 1];
        float y[4], dz[4], xh[4], dy[4];
        round4<T>(d, y);
        dz_at<T>(y[0], gv[0].x, k0, v0, dz[0], xh[0]);
        dz_at<T>(y[1], gv[0].y, k1, v0, dz[1], xh[1]);
        dz_at<T>(y[2], gv[1].x, k0, v1, dz[2], xh[2]);
        dz_at<T>(y[3], gv[1].y, k1, v1, dz[3], xh[3]);
        // dy = rstd gamma (dz - m1 - xhat m2); 0 where dz was masked
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4& mc = (i & 1) ? m1 : m0;
          dy[i] = ((i < 2) ? v0 : v1) ? fmaf(mc.x, dz[i], fmaf(xh[i], mc.z, mc.y)) : 0.0f;
        }
        if constexpr (kBf) {
          top[j] = pack_bf16(dy[0], dy[1]);
          bot[j] = pack_bf16(dy[2], dy[3]);
          mma16816(dw[j], ax, movmatrix_trans(top[j]), movmatrix_trans(bot[j]));
        } else {
          const int col = 8 * j + 2 * w.q;
          *(float2*)(dys + w.g * L.pitch + col) = make_float2(dy[0], dy[1]);
          *(float2*)(dys + (w.g + 8) * L.pitch + col) = make_float2(dy[2], dy[3]);
        }
      });
      if constexpr (kBf) {
        if constexpr (DWAV) {
          float dx[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const uint32_t af[4] = {top[2 * m], bot[2 * m], top[2 * m + 1], bot[2 * m + 1]};
            mma16816(dx[0], af, wt[m][0][0], wt[m][0][1]);
            mma16816(dx[1], af, wt[m][1][0], wt[m][1][1]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int tap = 8 * nt + 2 * w.q + (i & 1), row = w.g + (i >= 2 ? 8 : 0);
              if (tap < kTaps) dxs[(w.slice * kTile + f0 + row) * kTaps + tap] = dx[nt][i];
            }
        }
      } else {
        __syncwarp();
        const float* sf = (const float*)dys;
        for (int t = 0; t < kSub; ++t) {
          const float2 dv = *(const float2*)(sf + t * L.pitch + 2 * w.lane);
          const float* xr = (const float*)xb + (f0 + t) * s;
#pragma unroll
          for (int kk = 0; kk < kTaps; ++kk) {
            const float xv = xr[kk];
            dw[kk][0] = fmaf(xv, dv.x, dw[kk][0]);
            dw[kk][1] = fmaf(xv, dv.y, dw[kk][1]);
          }
        }
        if constexpr (DWAV) {
          for (int o = w.lane; o < kSub * kTaps; o += 32) {
            const int t = o / kTaps, kk = o % kTaps;
            const float* dr = sf + t * L.pitch;
            const float* wr = ws + kk * Cp + w.c0;
            float acc = 0.0f;
            for (int c = 0; c < kSlice; ++c) acc = fmaf(dr[c], wr[c], acc);
            dxs[(w.slice * kTile + f0 + t) * kTaps + kk] = acc;
          }
        }
      }
      __syncwarp();
    }
    if constexpr (DWAV) {
      __syncthreads();
      for (int i = threadIdx.x; i < L.span; i += kThreads) {
        const int tlo = i > kTaps - 1 ? (i - (kTaps - 1) + s - 1) / s : 0;
        const int thi = min(kTile - 1, i / s);
        float acc = 0.0f;
        for (int sl = 0; sl < L.nsl; ++sl)
          for (int t = tlo; t <= thi; ++t) acc += dxs[(sl * kTile + t) * kTaps + i - t * s];
        dxt[((size_t)b * a.ntiles + tile) * L.span + i] = acc;
      }
    }
    cp_async_wait0();
    if (next < a.ntiles) span_finish<T>(xr, xs + ((it + 1) & 1) * L.span_pad, L.span);
    __syncthreads();
  }
  // the block's dW: each warp's [10][64] into shared memory, then the warps of
  // a slice in warp order
#pragma unroll
  for (int i = 0; i < (kBf ? 8 : kTaps); ++i)
#pragma unroll
    for (int e = 0; e < (kBf ? 4 : 2); ++e) {
      const int tap = kBf ? w.g + (e >= 2 ? 8 : 0) : i;
      const int col = kBf ? 8 * i + 2 * w.q + (e & 1) : 2 * w.lane + e;
      if (tap < kTaps) red[(w.warp * kTaps + tap) * kSlice + col] = dw[i][e];
    }
  __syncthreads();
  float* dst = part + (size_t)(b * a.nb + blockIdx.x) * kTaps * a.C;
  for (int i = threadIdx.x; i < kTaps * Cp; i += kThreads) {
    const int r = i / Cp, c = i % Cp;
    if (c >= a.C) continue;
    float acc = 0.0f;
    for (int wi = c / kSlice; wi < kWarps; wi += w.nsl)
      acc += red[(wi * kTaps + r) * kSlice + c % kSlice];
    dst[r * a.C + c] = acc;
  }
}

// dst[col] = sum over rows of src[row, col] (src [rows, cols]), rows in a
// fixed order: a block takes 32 columns, its eight thread rows take rows r,
// r + 8, ... and are added in row order. Written in f32 or bf16.
__global__ void __launch_bounds__(kThreads)
    wav_fold_rows_kernel(const float* src, int rows, int cols, void* dst, int dst_bf16) {
  __shared__ float red[8][32];
  const int cl = threadIdx.x % 32, r = threadIdx.x / 32, col = blockIdx.x * 32 + cl;
  float acc = 0.0f;
  if (col < cols)
    for (int k = r; k < rows; k += 8) acc += src[(size_t)k * cols + col];
  red[r][cl] = acc;
  __syncthreads();
  if (r == 0 && col < cols) {
    for (int k = 1; k < 8; ++k) acc += red[k][cl];
    if (dst_bf16)
      ((bf16*)dst)[col] = __float2bfloat16(acc);
    else
      ((float*)dst)[col] = acc;
  }
}

// dwav[b, i] = the share of the tile that holds sample i, plus the K - s
// overhang of the tile before it.
__global__ void wav_fold_dx_kernel(const float* dxt, float* dwav, int B, int T,
                                   int ntiles, int span, int stride) {
  const long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= (long long)B * T) return;
  const int b = (int)(gi / T), i = (int)(gi % T), hop = kTile * stride;
  const int tile = i / hop, j = i - tile * hop;
  const float* row = dxt + (size_t)b * ntiles * span;
  float v = tile < ntiles ? row[(size_t)tile * span + j] : 0.0f;
  if (tile >= 1 && tile - 1 < ntiles && j + hop < span)
    v += row[(size_t)(tile - 1) * span + j + hop];
  dwav[gi] = v;
}

// Raise the dynamic shared-memory limit of kernel K once per size.
template <auto K>
void set_smem(size_t bytes) {
  static size_t done = 48 * 1024;
  if (bytes > done) {
    cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    done = bytes;
  }
}

bool shape_ok(int B, int T, int C, int K, int stride, int nb) {
  return K == kTaps && stride >= 1 && stride <= kMaxStride && kTaps % stride == 0 && C >= 8 &&
         C <= kMaxC &&
         (C & (C - 1)) == 0 && B >= 1 && T >= K && nb >= 1;
}

Geo geo(const float* wav, const void* w, int B, int T, int C, int stride, int nb) {
  const int T1 = (T - kTaps) / stride + 1;
  return Geo{wav, w, B, T, T1, C, stride, (T1 + kTile - 1) / kTile, nb};
}

template <typename T>
int forward(const Geo& a, const float* gamma, const float* beta, float* part, float* coef,
            void* out, float eps, cudaStream_t st) {
  const dim3 grid(a.nb, a.B);
  const size_t b0 = layout(sizeof(T), a.stride, a.C, 0, false).bytes;
  set_smem<wav_stats_kernel<T>>(b0);
  wav_stats_kernel<T><<<grid, kThreads, b0, st>>>(a, part);
  SMM_CHECK_LAUNCH();
  wav_fold_stats_kernel<<<(a.B * a.C + 255) / 256, 256, 0, st>>>(part, gamma, beta, coef, a.B,
                                                                 a.C, a.nb, a.T1, eps);
  SMM_CHECK_LAUNCH();
  const size_t b1 = layout(sizeof(T), a.stride, a.C, 1, false).bytes;
  set_smem<wav_apply_kernel<T>>(b1);
  wav_apply_kernel<T><<<grid, kThreads, b1, st>>>(a, coef, (T*)out);
  SMM_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int backward(const Geo& a, const float* gamma, const float* beta, const float* coef,
             const void* gy, float* part_a, float* co, float* dgb, float* part_b, void* dw,
             float* dxt, void* dwav, cudaStream_t st) {
  const dim3 grid(a.nb, a.B);
  const size_t ba = layout(sizeof(T), a.stride, a.C, 2, false).bytes;
  set_smem<wav_bwd_sums_kernel<T>>(ba);
  wav_bwd_sums_kernel<T><<<grid, kThreads, ba, st>>>(a, coef, gamma, beta, (const T*)gy, part_a);
  SMM_CHECK_LAUNCH();
  wav_fold_dz_kernel<<<(a.C + 31) / 32, kThreads, 0, st>>>(part_a, coef, gamma, co, dgb, a.B,
                                                           a.C, a.nb, a.T1);
  SMM_CHECK_LAUNCH();
  const bool want_dx = dxt != nullptr;
  const size_t bb = layout(sizeof(T), a.stride, a.C, 3, want_dx).bytes;
  if (want_dx) {
    set_smem<wav_bwd_grads_kernel<T, true>>(bb);
    wav_bwd_grads_kernel<T, true><<<grid, kThreads, bb, st>>>(a, coef, gamma, beta, co,
                                                              (const T*)gy, part_b, dxt);
  } else {
    set_smem<wav_bwd_grads_kernel<T, false>>(bb);
    wav_bwd_grads_kernel<T, false><<<grid, kThreads, bb, st>>>(a, coef, gamma, beta, co,
                                                               (const T*)gy, part_b, nullptr);
  }
  SMM_CHECK_LAUNCH();
  const int cols = kTaps * a.C;
  wav_fold_rows_kernel<<<(cols + 31) / 32, kThreads, 0, st>>>(part_b, a.B * a.nb, cols, dw,
                                                              (int)(sizeof(T) == 2));
  SMM_CHECK_LAUNCH();
  if (want_dx) {
    const long long n = (long long)a.B * a.T;
    const int span = layout(sizeof(T), a.stride, a.C, 3, true).span;
    wav_fold_dx_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        dxt, (float*)dwav, a.B, a.T, a.ntiles, span, a.stride);
    SMM_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (of w and out). wav f32 [B, T]; w [K, C]; gamma,
// beta f32 [C]; part f32 [B, nb, 2, C] and coef f32 [4, B, C] (mean, rstd,
// scale, shift; the backward reads the first two) are the wrapper's scratch;
// out [B, T1, C]. Launches pass 1, the fold and
// pass 2. Returns the first CUDA error, or 0.
extern "C" int smm_wav_frontend_fwd(int dtype, const float* wav, const void* w,
                                    const float* gamma, const float* beta, float* part,
                                    float* coef, void* out, int B, int T, int C, int K,
                                    int stride, int nb, float eps, void* stream) {
  if (!shape_ok(B, T, C, K, stride, nb)) return (int)cudaErrorInvalidValue;
  const Geo a = geo(wav, w, B, T, C, stride, nb);
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? forward<bf16>(a, gamma, beta, part, coef, out, eps, st)
                    : forward<float>(a, gamma, beta, part, coef, out, eps, st);
}

// The backward: gy [B, T1, C] in the output's type; part_a f32 [B, nb, 2, C],
// co f32 [3, B, C], part_b f32 [B, nb, K, C] scratch; dgb f32 [2, C] =
// dgamma, dbeta; dw [K, C] in the compute type; dxt f32
// [B, ceil(T1 / 128), 128 s + K] scratch and dwav f32 [B, T], both null
// when no waveform gradient is wanted.
extern "C" int smm_wav_frontend_bwd(int dtype, const float* wav, const void* w,
                                    const float* gamma, const float* beta, const float* coef,
                                    const void* gy, float* part_a, float* co, float* dgb,
                                    float* part_b, void* dw, float* dxt, void* dwav, int B,
                                    int T, int C, int K, int stride, int nb, void* stream) {
  if (!shape_ok(B, T, C, K, stride, nb) || (dxt == nullptr) != (dwav == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geo a = geo(wav, w, B, T, C, stride, nb);
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? backward<bf16>(a, gamma, beta, coef, gy, part_a, co, dgb, part_b, dw, dxt,
                                     dwav, st)
                    : backward<float>(a, gamma, beta, coef, gy, part_a, co, dgb, part_b, dw, dxt,
                                      dwav, st);
}

// Bytes of dynamic shared memory of one pass (0 stats, 1 apply, 2 backward
// sums, 3 backward gradients) at this type, stride and width.
extern "C" int smm_wav_frontend_smem(int dtype, int pass, int dwav, int stride, int C) {
  return layout(dtype == 1 ? 2 : 4, stride, C, pass, dwav != 0).bytes;
}
