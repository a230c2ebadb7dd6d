// Flash attention forward for Hopper: out = softmax(q k^T / sqrt(D) + bias) v
// and each row's softmax statistics, for q [B, Sq, H, D] and k, v
// [B, Sk, H, D]: the C entry point, and the bodies for f32 (any width), for
// the head widths 4 and 8 of the small presets (exact FMA loops on the CUDA
// cores) and for bf16 at D = 16 and 32 (WMMA m16n16k16). bf16 at D = 64, 96
// and 128, the long-clip path's widths, runs flash_attention_wgmma.cu.
//
// Replaces simple_multimodal_tpu/ops/pallas/flash_attention.py, `_fwd_kernel`
// via `_flash_forward`. The TPU kernel's head groups, 512-blocks, 128-lane
// padding and [B, H, S, D] transposes serve VMEM and Mosaic and are not
// carried over: here one block owns 64 query rows of one (batch, head),
// streams 64-key tiles of K and V through shared memory with an online
// softmax, reads every operand in its [B, S, H, D] layout through strides,
// and reads the bias through strides too (stride 0 on a broadcast axis).
// Keys past Sk get weight 0 in the kernel, so ragged lengths need no padded
// copy. As in the TPU kernel the running maximum starts at -1e30 (finite),
// probabilities are rounded to the input type before P.V, sums are f32, a
// row whose exponentials sum to 0 gives zeros, and a row whose every key
// carries a -1e30 bias attends uniformly over its Sk keys. The TPU kernel
// saves lse = m + log(l) for its backward; here the row maximum m and the
// sum l are saved apart, because at such a fully masked row m = -1e30
// absorbs log(l) in f32 and probabilities recomputed from lse come out as 1
// instead of 1/Sk.
//
// What bounds it on this card: operations (4 Sq Sk D FLOP per (batch, head)
// on Sq D + 2 Sk D elements). These bodies are the exact side of the f32
// checks and the small presets' path and stay simple: one 128-thread block
// per 64 rows, one synchronous stage, scores through shared-memory scratch.

#include "flash_attention.cuh"

namespace {

using namespace smm;

// End of a query row: normalise, store, and the row statistics.
template <typename T, int DPL, int D>
__device__ __forceinline__ void finish_row(const FlashArgs& a, const FlashOut& w, T* O, int b,
                                           int h, int s, float m, float l,
                                           const float (&o)[DPL]) {
  const int lane = threadIdx.x & 31;
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int c = lane + 32 * j;
    if (c < D) O[(size_t)s * w.so.token + c] = from_f32<T>(o[j] * inv);
  }
  if (lane == 0) {
    const size_t i = ((size_t)b * a.H + h) * a.Sq + s;
    w.m[i] = m;
    w.l[i] = l;
  }
}

template <int D>
__global__ void __launch_bounds__(kAttnThreads) flash_fwd_wmma_kernel(FlashArgs a, FlashOut w) {
  using namespace nvcuda;
  using P = WmmaPlan<D, false>;
  constexpr int LDB = P::LDB, LDS = P::LDS, LDP = P::LDP;
  constexpr int DPL = (D + 31) / 32, KD = D / 16;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Qs = (bf16*)(smem_raw + P::q);
  bf16* Ks = (bf16*)(smem_raw + P::k);
  bf16* Vs = (bf16*)(smem_raw + P::v);
  float* Sw = (float*)(smem_raw + P::s) + warp * 16 * LDS;
  bf16* Pw = (bf16*)(smem_raw + P::p) + warp * 16 * LDP;

  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const bf16* Q = head_rows<bf16>(a.q, a.sq, b, h, D);
  const bf16* K = head_rows<bf16>(a.k, a.sk, b, h, D);
  const bf16* V = head_rows<bf16>(a.v, a.sv, b, h, D);

  stage_rows<D, LDB>(Qs, kTQ, [&](int r) -> const bf16* {
    return q0 + r < Sq ? Q + (size_t)(q0 + r) * a.sq.token : nullptr;
  });
  __syncthreads();
  FragA qf[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LDB + kk * 16, LDB);

  float m[16], l[16], o[16][DPL];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kMaskFill;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[r][j] = 0.0f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kTK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D, LDB>(Ks, kTK, [&](int r) -> const bf16* {
      return k0 + r < Sk ? K + (size_t)(k0 + r) * a.sk.token : nullptr;
    });
    stage_rows<D, LDB>(Vs, kTK, [&](int r) -> const bf16* {
      return k0 + r < Sk ? V + (size_t)(k0 + r) * a.sv.token : nullptr;
    });
    __syncthreads();

    FragC acc;
#pragma unroll
    for (int j = 0; j < kTK / 16; ++j) {  // scores: 16 rows x 64 keys
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        FragBt kb;
        wmma::load_matrix_sync(kb, Ks + j * 16 * LDB + kk * 16, LDB);
        wmma::mma_sync(acc, qf[kk], kb, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qg = q0 + warp * 16 + r;
      const float s0 = flash_score(a, Sw[r * LDS + lane], b, h, qg, k0 + lane);
      const float s1 = flash_score(a, Sw[r * LDS + lane + 32], b, h, qg, k0 + lane + 32);
      const float mnew = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float alpha = __expf(m[r] - mnew);
      const float p0 = __expf(s0 - mnew), p1 = __expf(s1 - mnew);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = mnew;
#pragma unroll
      for (int j = 0; j < DPL; ++j) o[r][j] *= alpha;
      Pw[r * LDP + lane] = __float2bfloat16(p0);
      Pw[r * LDP + lane + 32] = __float2bfloat16(p1);
    }
    __syncwarp();

    // o += P . V: 16 rows x D, through the scores scratch
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        FragA pa;
        FragB vb;
        wmma::load_matrix_sync(pa, Pw + kk * 16, LDP);
        wmma::load_matrix_sync(vb, Vs + kk * 16 * LDB + j * 16, LDB);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int c = lane + 32 * j;
        if (c < D) o[r][j] += Sw[r * LDS + c];
      }
    __syncwarp();  // Sw is the next tile's scores scratch
  }

  bf16* O = head_rows<bf16>(w.out, w.so, b, h, D);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + warp * 16 + r;
    if (s < Sq) finish_row<bf16, DPL, D>(a, w, O, b, h, s, m[r], l[r], o[r]);
  }
}

// f32 inputs, and head widths below the tensor cores' 16: the same algorithm
// as f32 FMA loops from shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads) flash_fwd_kernel(FlashArgs a, FlashOut w) {
  constexpr int LD = D + 1;  // odd pitch: lanes reading different rows hit different banks
  constexpr int DPL = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTQ * LD;
  float* Vs = Ks + kTK * LD;
  float* Ps = Vs + kTK * LD;  // [4 warps][16][kTK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const T* Q = head_rows<T>(a.q, a.sq, b, h, D);
  const T* K = head_rows<T>(a.k, a.sk, b, h, D);
  const T* V = head_rows<T>(a.v, a.sv, b, h, D);

  for (int e = tid; e < kTQ * D; e += kAttnThreads) {
    const int r = e / D, d = e % D, s = q0 + r;
    Qs[r * LD + d] = s < Sq ? to_f32(Q[(size_t)s * a.sq.token + d]) : 0.0f;
  }

  float m[16], l[16], o[16][DPL];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kMaskFill;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[r][j] = 0.0f;
  }
  float* P = Ps + warp * 16 * kTK;
  const float* Qw = Qs + warp * 16 * LD;

  for (int k0 = 0; k0 < Sk; k0 += kTK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kTK * D; e += kAttnThreads) {
      const int r = e / D, d = e % D, s = k0 + r;
      const bool ok = s < Sk;
      Ks[r * LD + d] = ok ? to_f32(K[(size_t)s * a.sk.token + d]) : 0.0f;
      Vs[r * LD + d] = ok ? to_f32(V[(size_t)s * a.sv.token + d]) : 0.0f;
    }
    __syncthreads();

    // scores for this warp's 16 rows x keys (lane, lane + 32)
    float sc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) sc[r][0] = sc[r][1] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float ka = Ks[lane * LD + d], kb = Ks[(lane + 32) * LD + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = Qw[r * LD + d];
        sc[r][0] = fmaf(qv, ka, sc[r][0]);
        sc[r][1] = fmaf(qv, kb, sc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qg = q0 + warp * 16 + r;
      const float s0 = flash_score(a, sc[r][0], b, h, qg, k0 + lane);
      const float s1 = flash_score(a, sc[r][1], b, h, qg, k0 + lane + 32);
      const float mnew = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float alpha = __expf(m[r] - mnew);
      const float p0 = __expf(s0 - mnew), p1 = __expf(s1 - mnew);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = mnew;
#pragma unroll
      for (int j = 0; j < DPL; ++j) o[r][j] *= alpha;
      P[r * kTK + lane] = p0;
      P[r * kTK + lane + 32] = p1;
    }
    __syncwarp();

    // o += P . V, this lane's output columns lane + 32 j
    for (int kk = 0; kk < kTK; ++kk) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < D ? Vs[kk * LD + c] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = P[r * kTK + kk];
#pragma unroll
        for (int j = 0; j < DPL; ++j) o[r][j] = fmaf(p, vv[j], o[r][j]);
      }
    }
    __syncwarp();
  }

  T* O = head_rows<T>(w.out, w.so, b, h, D);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int s = q0 + warp * 16 + r;
    if (s < Sq) finish_row<T, DPL, D>(a, w, O, b, h, s, m[r], l[r], o[r]);
  }
}

template <typename T, int D>
int launch_d(const FlashArgs& a, const FlashOut& w, int B, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value && flash_wgmma_width(D)) {
    return flash_fwd_wgmma_launch(a, w, B, D, st);
  } else {
    const dim3 grid((a.Sq + kTQ - 1) / kTQ, a.H, B);
    if constexpr (std::is_same<T, bf16>::value && D % 16 == 0) {
      constexpr size_t smem = WmmaPlan<D, false>::bytes;
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_wmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      flash_fwd_wmma_kernel<D><<<grid, kAttnThreads, smem, st>>>(a, w);
    } else {
      constexpr size_t smem =
          sizeof(float) * ((size_t)(kTQ + 2 * kTK) * (D + 1) + 4 * 16 * kTK);
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      flash_fwd_kernel<T, D><<<grid, kAttnThreads, smem, st>>>(a, w);
    }
    SMM_CHECK_LAUNCH();
    return 0;
  }
}

// Head widths the kernel is instantiated for; the wrapper checks D first.
template <typename T>
int launch(const FlashArgs& a, const FlashOut& w, int B, int D, cudaStream_t st) {
  switch (D) {
    case 4: return launch_d<T, 4>(a, w, B, st);
    case 8: return launch_d<T, 8>(a, w, B, st);
    case 16: return launch_d<T, 16>(a, w, B, st);
    case 32: return launch_d<T, 32>(a, w, B, st);
    case 64: return launch_d<T, 64>(a, w, B, st);
    case 96: return launch_d<T, 96>(a, w, B, st);
    case 128: return launch_d<T, 128>(a, w, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. q/out [B, Sq, H, D] and k/v [B, Sk, H, D] in
// place; `strides` (host, int64, elements) = batch and token stride of q, k,
// v, out, then the bias's four strides over (batch, head, query, key). bias
// f32 or null; stats f32 [2, B, H, Sq] (row maximum, then row sum). Returns
// the first CUDA error, or 0.
extern "C" int smm_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* out, float* stats, const float* bias,
                                   const long long* strides, int B, int Sq, int Sk, int H, int D,
                                   void* stream) {
  const long long* s = strides;
  FlashArgs a{q, k, v, {s[0], s[1]}, {s[2], s[3]}, {s[4], s[5]}, bias, s[8], s[9], s[10], s[11],
              Sq, Sk, H, 1.0f / sqrtf((float)D)};
  const FlashOut w{out, {s[6], s[7]}, stats, stats + (size_t)B * H * Sq};
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1 ? launch<bf16>(a, w, B, D, st) : launch<float>(a, w, B, D, st);
}

// Dynamic shared memory of a wgmma flash kernel (which: 0 forward, 1 dq,
// 2 dk/dv, 3 the forward with attention_block's dropout) at head width D, in
// bytes; 0 where there is none.
extern "C" int smm_flash_wgmma_smem(int which, int D) {
  switch (which) {
    case 0: return flash_fwd_wgmma_smem(D);
    case 1: return flash_bwd_dq_wgmma_smem(D);
    case 2: return flash_bwd_dkv_wgmma_smem(D);
    case 3: return attention_core_wgmma_smem(D);
    default: return 0;
  }
}
