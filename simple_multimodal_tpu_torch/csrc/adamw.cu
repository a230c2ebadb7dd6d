// AdamW over the leaves of one optimizer (train/optim.py, AdamWChain) in two
// launches: foreach_sumsq_kernel, each gradient's sum of squares (the
// per-tensor norms that the global gradient norm is made of), then
// foreach_adamw_kernel, the clip, the Adam moments, the bias correction, the
// decoupled weight decay, the backbone scale and the update of every element
// in one pass, p, m and v written in place.
//
// It replaces no TPU kernel: the JAX package leaves its optax chain
// (simple_multimodal_tpu/train/optim.py: clip_by_global_norm, adam, weight
// decay, the backbone scale) to XLA, which fuses the elementwise chain. It
// was added because the port's plain version, thirteen torch._foreach_*
// passes, reads and writes every element ~33 times (about 132 bytes an
// element, with two temporary lists the size of the parameters): 100 ms of
// an H100 train step over the 2.15 B parameters of the Moonlight tower
// configuration.
//
// What bounds it on this card: bytes. An element needs g read twice (the
// norm, then the update) and p, m, v read and written once: 32 bytes, 20.6 ms
// at 3.35 TB/s for 2.15 B elements and 3.9 ms for the standard model's
// 0.41 B. No product, so the tensor cores play no part.
//
// What the design does about it:
// - One chunk table for every leaf, built once with the optimizer
//   (ops/hopper/adamw.py): chunk c covers `chunk` elements of leaf
//   chunk_leaf[c], from (c − chunk_begin[leaf]) · chunk. Both kernels are
//   persistent grids that walk the chunks c = blockIdx.x, + gridDim.x, ...,
//   so one launch covers any number and size of leaves.
// - Leaves are found through pointer tables: p, m, v uploaded once, the
//   gradients every step (they are new tensors after every backward). A null
//   gradient reads as zero.
// - Elements move as 16-byte vectors (float4) wherever the chunk's four
//   pointers are 16-byte aligned, with a scalar tail; a leaf whose base is
//   not aligned (a view into a flat buffer) takes the scalar path.
// - The sums are deterministic: each chunk's partial is a fixed tree of the
//   block, and the last block to finish (it takes the last ticket of one
//   integer counter, which it resets) folds each leaf's partials in chunk
//   order, one warp a leaf. No floating-point sum goes through atomics, so
//   two runs on the same inputs are bit-equal.
// - The update reads the global norm from the device (the caller combines
//   the per-leaf norms, over a model axis too) and forms the clip
//   coefficient itself, so the host never waits for the device. The
//   gradients are not written: the plain version scaled them in place, and
//   nothing reads them after the update.
// - Every step runs in f32 in the plain version's order (the hyperparameters
//   as f32 scalars, true division and square root), so the kernel follows
//   the chain to rounding.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace smm {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;

// A persistent grid: as many blocks as stay resident, or one a chunk where that is fewer.
int grid_for(int n_chunks) {
  const int resident = hopper::sm_count() * kBlocksPerSM;
  return n_chunks < resident ? n_chunks : resident;
}

// The chunk table: chunk c is leaf chunk_leaf[c]'s elements [start, start + len).
struct Chunks {
  const long long* numel;   // [n] elements of each leaf
  const int* chunk_leaf;    // [n_chunks]
  const int* chunk_begin;   // [n + 1] first chunk of each leaf
  int n_chunks, chunk;
};

struct Span {
  int leaf;
  long long start;
  int len;
};

__device__ __forceinline__ Span span_of(const Chunks& t, int c) {
  const int leaf = t.chunk_leaf[c];
  const long long start = (long long)(c - t.chunk_begin[leaf]) * t.chunk;
  const long long rest = t.numel[leaf] - start;
  return {leaf, start, (int)(rest < t.chunk ? rest : t.chunk)};
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// The block's sum of v in a fixed order (valid in thread 0).
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
  if (warp == 0) t = warp_sum(lane < kWarps ? red[lane] : 0.0f);
  __syncthreads();
  return t;
}

// partial[c] = Σ g² over chunk c; then the last block writes
// norms[leaf] = sqrt(Σ of the leaf's partials in chunk order).
__global__ void __launch_bounds__(kThreads) foreach_sumsq_kernel(
    const float* const* grads, Chunks t, int n_leaves, float* partial, unsigned* ticket,
    float* norms) {
  __shared__ float red[kWarps];
  __shared__ bool last;
  for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    const Span s = span_of(t, c);
    const float* g = grads[s.leaf];
    float acc = 0.0f;
    if (g != nullptr) {
      g += s.start;
      int head = 0;
      if (aligned16(g)) {
        const float4* g4 = reinterpret_cast<const float4*>(g);
        float4 a4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int i = threadIdx.x; i < s.len / 4; i += kThreads) {
          const float4 x = g4[i];
          a4.x = fmaf(x.x, x.x, a4.x);
          a4.y = fmaf(x.y, x.y, a4.y);
          a4.z = fmaf(x.z, x.z, a4.z);
          a4.w = fmaf(x.w, x.w, a4.w);
        }
        acc = (a4.x + a4.y) + (a4.z + a4.w);
        head = s.len / 4 * 4;
      }
      for (int i = head + threadIdx.x; i < s.len; i += kThreads) acc = fmaf(g[i], g[i], acc);
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) partial[c] = acc;
  }
  // The last block to get here folds: its ticket is taken after every
  // other block's partials are visible (the fence before each ticket).
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int leaf = warp; leaf < n_leaves; leaf += kWarps) {
    float acc = 0.0f;
    const int end = t.chunk_begin[leaf + 1];
#pragma unroll 8
    for (int c = t.chunk_begin[leaf] + lane; c < end; c += 32) acc += __ldcg(partial + c);
    acc = warp_sum(acc);
    if (lane == 0) norms[leaf] = sqrtf(acc);
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// The hyperparameters of one update, as the chain's f32 scalars.
struct Hyper {
  float clip, lr, b1, b2, a1, a2, bc1, bc2, eps, wd, bb_scale;
};

// One element through the chain: clip, m, v, bias correction, sqrt, + eps,
// divide, + wd·p, × the backbone scale, p − lr·update.
__device__ __forceinline__ void adamw_element(float g, float& p, float& m, float& v,
                                              const Hyper& h, float coef, float scale) {
  g = g * coef;
  m = m * h.b1;
  m = m + h.a1 * g;
  v = v * h.b2;
  v = v + h.a2 * g * g;
  float u = m / h.bc1;
  const float d = sqrtf(v / h.bc2) + h.eps;
  u = u / d;
  u = u + h.wd * p;
  u = u * scale;
  p = p + -h.lr * u;
}

__global__ void __launch_bounds__(kThreads) foreach_adamw_kernel(
    const float* const* grads, float* const* params, float* const* mu, float* const* nu,
    const int* backbone, Chunks t, const float* norm, Hyper h) {
  const float n = *norm;
  const float coef = n < h.clip ? 1.0f : h.clip / n;
  for (int c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    const Span s = span_of(t, c);
    const float* g = grads[s.leaf];
    float* p = params[s.leaf] + s.start;
    float* m = mu[s.leaf] + s.start;
    float* v = nu[s.leaf] + s.start;
    if (g != nullptr) g += s.start;
    const float scale = backbone[s.leaf] ? h.bb_scale : 1.0f;
    int head = 0;
    if (aligned16(p) && aligned16(m) && aligned16(v) && (g == nullptr || aligned16(g))) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (int i = threadIdx.x; i < s.len / 4; i += kThreads) {
        const float4 gv = g4 != nullptr ? g4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 pv = p4[i], mv = m4[i], vv = v4[i];
        adamw_element(gv.x, pv.x, mv.x, vv.x, h, coef, scale);
        adamw_element(gv.y, pv.y, mv.y, vv.y, h, coef, scale);
        adamw_element(gv.z, pv.z, mv.z, vv.z, h, coef, scale);
        adamw_element(gv.w, pv.w, mv.w, vv.w, h, coef, scale);
        p4[i] = pv;
        m4[i] = mv;
        v4[i] = vv;
      }
      head = s.len / 4 * 4;
    }
    for (int i = head + threadIdx.x; i < s.len; i += kThreads)
      adamw_element(g != nullptr ? g[i] : 0.0f, p[i], m[i], v[i], h, coef, scale);
  }
}

}  // namespace
}  // namespace smm

using namespace smm;

// norms [n_leaves] = ‖g_i‖ of the f32 leaves in the table grads [n] (device
// pointers, null for a zero gradient), over the chunk table (numel [n]
// int64, chunk_leaf [n_chunks] int32, chunk_begin [n + 1] int32, `chunk`
// elements a chunk, a multiple of 4); partial [n_chunks] f32 and ticket [1]
// (0 before and after) are the caller's scratch. Returns the first CUDA
// error, or 0.
extern "C" int smm_foreach_sumsq(const void* grads, const void* numel, const void* chunk_leaf,
                                 const void* chunk_begin, int n_leaves, int n_chunks, int chunk,
                                 void* partial, void* ticket, void* norms, void* stream) {
  if (n_leaves <= 0) return 0;
  if (chunk <= 0 || chunk % 4) return (int)cudaErrorInvalidValue;
  const Chunks t{(const long long*)numel, (const int*)chunk_leaf, (const int*)chunk_begin,
                 n_chunks, chunk};
  // one block even with no chunks: the last (only) block writes the norms
  const int grid = n_chunks > 0 ? grid_for(n_chunks) : 1;
  foreach_sumsq_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float* const*)grads, t, n_leaves, (float*)partial, (unsigned*)ticket,
      (float*)norms);
  return (int)cudaGetLastError();
}

// One AdamW step of the f32 leaves in place: the tables grads, params, mu,
// nu [n] (device pointers; a null gradient reads as zero), backbone [n]
// int32 (1: × bb_scale), the chunk table as smm_foreach_sumsq's; norm [1]
// f32 on the device, the global norm before clipping (coefficient 1 where
// norm < clip, else clip / norm). a1 = 1 − b1, a2 = 1 − b2, bc1 = 1 − b1^t,
// bc2 = 1 − b2^t. Returns the first CUDA error, or 0.
extern "C" int smm_foreach_adamw(const void* grads, const void* params, const void* mu,
                                 const void* nu, const void* backbone, const void* numel,
                                 const void* chunk_leaf, const void* chunk_begin, int n_chunks,
                                 int chunk, const void* norm, float clip, float lr, float b1,
                                 float b2, float a1, float a2, float bc1, float bc2, float eps,
                                 float wd, float bb_scale, void* stream) {
  if (n_chunks <= 0) return 0;
  if (chunk <= 0 || chunk % 4) return (int)cudaErrorInvalidValue;
  const Chunks t{(const long long*)numel, (const int*)chunk_leaf, (const int*)chunk_begin,
                 n_chunks, chunk};
  const Hyper h{clip, lr, b1, b2, a1, a2, bc1, bc2, eps, wd, bb_scale};
  foreach_adamw_kernel<<<grid_for(n_chunks), kThreads, 0, (cudaStream_t)stream>>>(
      (const float* const*)grads, (float* const*)params, (float* const*)mu, (float* const*)nu,
      (const int*)backbone, t, (const float*)norm, h);
  return (int)cudaGetLastError();
}
