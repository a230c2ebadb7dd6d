// The routed experts of one MoE layer (models/deepseek.py, MoE; the wrapper
// is ops/hopper/moe_experts.py) in a fixed number of launches whose shapes
// do not depend on the routing: the host never reads how many rows an
// expert got. Forward, for the n held experts of one layer:
//   moe_cast_kernel     the f32 gate, up and down weights of every held
//                       expert (a table of pointers) -> stacked bf16 W1s
//                       [n, 2F, E] (gate and up rows interleaved in blocks
//                       of 64) and W2s [n, E, F];
//   moe_gather_kernel   h's rows into expert-sorted order xs [rows, E],
//                       each expert's segment padded with zero rows to a
//                       multiple of 128, and each row's routing weight ws;
//   moe_gemm_kernel<0>  gu = xs . W1s[e]^T per segment, bf16, and its
//                       epilogue act = bf16(silu(g) * u) in f32;
//   moe_gemm_kernel<1>  ys = ws * (act . W2s[e]^T), f32;
//   moe_combine_kernel  out[t] = the sum of token t's rows of ys in
//                       ascending expert order, f32 (no atomics).
// Backward: moe_gather_kernel again (xs from h, dys = dout's rows);
// <2> dys . W2s[e] with the SiLU-product backward in its epilogue (dgu, the
// weighted activation aw = ws * act, each row's partial routing-weight
// gradient); <4> dW1 = dgu^T . xs and <5> dW2 = dys^T . aw per expert over
// its segment; <3> dxs = dgu . W1s[e]; moe_token_grad_kernel: dh[t] and the
// routing weights' gradient, each a fixed-order sum over token t's rows.
//
// It replaces no TPU kernel: the JAX package has no mixture of experts (the
// DeepSeek tower is the port's own text backbone, PR 19's configuration).
// It replaces the per-expert loop of the parent's MoE.forward: one host read
// of the row counts a layer (which drained the device's queue), then ~680
// small operations forward and backward, on a step whose host issued work
// more slowly than the card ran it.
//
// What bounds it on this card: operations, 3 products of 2 rows E F each
// forward and 6 backward over ~6 000 rows a layer (moonlight.train: 0.32 ms
// a layer at 989 TFLOP/s), and the bytes of the weight cast (415 MB a layer,
// 0.12 ms at 3.35 TB/s).
//
// What the design does about it:
// - The row counts and each expert's padded offset stay on the device
//   (poff, [n + 1], computed by the wrapper with PyTorch operations). Every
//   per-row buffer is sized for the bound T * min(k, n) + 128 n, so no
//   shape depends on the routing.
// - The products are one kernel, moe_gemm_kernel<MODE>: the block tile,
//   ring and warpgroups of gemm_wgmma.cu (128 x 128 tile, two consumer
//   warpgroups of 64 rows, 64-deep K steps in a ring of three 32 KB stages,
//   thread 0 refills a stage once both warpgroups let go of it, two blocks
//   an SM), made persistent: a grid of at most two blocks an SM walks a tile
//   list that each block derives from poff, so the blocks never outnumber
//   the work, and the ring runs on across tiles, the next tile's first K
//   steps loading during an epilogue. Tiles of the row-grouped products
//   (modes 0-3) cover one expert's 128-row strip each (segments are padded
//   to 128, so no tile straddles two experts); those of the weight
//   gradients (modes 4, 5) one 128 x 128 block of one expert's gradient,
//   with a K loop as long as the expert's segment (none for an idle expert,
//   which writes zeros).
// - Every operand is read in place by TMA: row-major K-major boxes where the
//   contraction runs along rows, MN-major ([K][64] boxes read with the
//   transpose bit of wgmma) where it runs down them: the weights in the
//   input gradients, dgu, xs, dys and aw in the weight gradients. Padding
//   rows are zeros in every operand, so the weight gradients' K loops need
//   no mask.
// - gate and up come from one product: a 128-column tile of W1s holds 64
//   gate and the same 64 up rows, so a thread holds g and u of the same
//   element and the SiLU product is formed on the accumulators. gu is kept
//   bf16 (the backward's only saved activation), and act is formed from the
//   bf16-rounded g and u, as the backward recomputes it.
// - The sums over a token's experts (out, dh, the routing weights'
//   gradient) are gathers in a fixed order, ascending expert, as the
//   parent's sequence of index_add_ calls added them: two runs give the
//   same bits.
// Measured on the card (PERF.md): one layer forward and backward at the
// moonlight.train shapes takes 1.3-1.5 ms of device time, the products
// 0.86-1.05 ms of it against a bound of 0.32-0.40 ms. Tried and dropped: one
// block an SM with six stages (1.5-1.8 ms); zeroing an idle expert's
// accumulators in registers, which made ptxas serialize every mode's wgmma
// pipeline (an accumulator defined outside wgmma), as spills did.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace smm {
namespace {

namespace hp = smm::hopper;

constexpr int kMaxExperts = 64;
constexpr int kMaxK = 8;
constexpr int kBM = 128;  // rows of a block tile: two warpgroups of 64; an expert's segment
constexpr int kBN = 128;  // columns of a block tile
constexpr int kBK = 64;   // K step: one 128-byte swizzle atom
constexpr int kSw = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 2;
constexpr int kHalf = 64 * kBK * 2;      // one [64][64] bf16 box
constexpr int kOperand = 2 * kHalf;      // one operand of a stage
constexpr int kStage = 2 * kOperand;     // 32 KB
constexpr int kStages = 3;
constexpr int kBars = kStages * kStage;  // full[], empty[]
constexpr int kSmem = kBars + 16 * kStages + 1024;

enum Mode { GATE_UP = 0, DOWN = 1, DACT = 2, DX = 3, DW1 = 4, DW2 = 5 };

__host__ __device__ constexpr bool by_rows(int m) { return m <= DX; }
__host__ __device__ constexpr int a_mn(int m) { return m >= DW1 ? 1 : 0; }
__host__ __device__ constexpr int b_mn(int m) { return m >= DACT ? 1 : 0; }

struct MoeMaps {
  CUtensorMap a, b;
};

struct MoeArgs {
  const int* poff;  // [n + 1] each expert's first row; segments are multiples of kBM
  int n, E, F;
  int K;       // modes 0-3: the contraction; 4-5: unused (an expert's segment)
  int mt, nt;  // tiles of the output: mt row tiles an expert (modes 4-5), nt column tiles
  int b_rows;  // modes 0-3: rows of one expert's block of the stacked weight
  const bf16* gu;   // DACT: the forward's gate|up
  const float* ws;  // DOWN, DACT: each row's routing weight, 0 on padding rows
  void* out0;
  void* out1;
  float* part;  // DACT: [rows, F / kBN] the routing-weight gradient's partials
};

struct Tile {
  int a_row, a_col, b_row, b_col;  // origins of the operands' boxes
  int nk, m0, n0, e;
};

template <int MODE>
__device__ __forceinline__ Tile tile_of(const MoeArgs& g, const int* offs, int t) {
  Tile tl;
  if constexpr (by_rows(MODE)) {
    const int rt = t / g.nt, nt = t - rt * g.nt, row = rt * kBM;
    int e = 0;
    while (offs[e + 1] <= row) ++e;  // row < offs[n]; empty segments are skipped
    tl.e = e, tl.m0 = row, tl.n0 = nt * kBN, tl.nk = g.K / kBK;
    tl.a_row = row, tl.a_col = 0;
    if (b_mn(MODE))  // the weight's rows are the contraction
      tl.b_row = e * g.b_rows, tl.b_col = nt * kBN;
    else  // the weight's rows are the output's columns
      tl.b_row = e * g.b_rows + nt * kBN, tl.b_col = 0;
  } else {
    const int per = g.mt * g.nt, e = t / per, r = t - e * per, mt = r / g.nt;
    tl.e = e, tl.m0 = mt * kBM, tl.n0 = (r - mt * g.nt) * kBN;
    tl.nk = (offs[e + 1] - offs[e]) / kBK;
    tl.a_row = offs[e], tl.a_col = tl.m0, tl.b_row = offs[e], tl.b_col = tl.n0;
  }
  return tl;
}

// thread 0: K step kt of a tile into the stage at dst. A K-major operand is
// one [128 rows][64] box at (k, row); an MN-major one two [64 K rows][64]
// boxes side by side.
template <int MODE>
__device__ __forceinline__ void load_step(const MoeMaps& maps, const Tile& tl, int kt,
                                          uint32_t dst, uint32_t bar) {
  const int k0 = kt * kBK;
  hp::mbar_arrive_expect_tx(bar, kStage);
  if (a_mn(MODE)) {
    hp::tma_load_2d(dst, &maps.a, bar, tl.a_col, tl.a_row + k0);
    hp::tma_load_2d(dst + kHalf, &maps.a, bar, tl.a_col + 64, tl.a_row + k0);
  } else {
    hp::tma_load_2d(dst, &maps.a, bar, k0, tl.a_row);
  }
  const uint32_t b = dst + kOperand;
  if (b_mn(MODE)) {
    hp::tma_load_2d(b, &maps.b, bar, tl.b_col, tl.b_row + k0);
    hp::tma_load_2d(b + kHalf, &maps.b, bar, tl.b_col + 64, tl.b_row + k0);
  } else {
    hp::tma_load_2d(b, &maps.b, bar, k0, tl.b_row);
  }
}

// d (+)= A . B, m64n128k16, A and B from shared memory; TA / TB = 1: that
// operand MN-major (hopper.cuh's wgmma_ss fixes A K-major).
template <int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" SMM_REG64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : SMM_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float2 bf16_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hp::pack_bf16(a, b);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Row i of a weight-gradient tile in the parameters' layout. DW1: tile row
// i of W1s block mt is gate (i < 64: warpgroup 0) or up (warpgroup 1) row
// 64 mt + i % 64 of [n][gate, up][F][E]; DW2: [n][E][F].
template <int MODE>
__device__ __forceinline__ float* dw_row(const MoeArgs& g, const Tile& tl, int i) {
  float* dw = (float*)g.out0;
  if constexpr (MODE == DW1)
    return dw + (((size_t)tl.e * 2 + (i >> 6)) * g.F + tl.m0 / 2 + (i & 63)) * g.E;
  else
    return dw + ((size_t)tl.e * g.E + tl.m0 + i) * g.F;
}

// A weight-gradient tile of an expert with no rows: zeros.
template <int MODE>
__device__ __forceinline__ void zero_tile(const MoeArgs& g, const Tile& tl) {
  for (int i = threadIdx.x; i < kBM * kBN / 4; i += kThreads)
    *reinterpret_cast<float4*>(dw_row<MODE>(g, tl, i / (kBN / 4)) + tl.n0 + i % (kBN / 4) * 4) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The epilogue of one tile on this thread's two rows (r = lr, lr + 8 of the
// tile) and its column pair of every 8-column block (hopper.cuh's layout).
template <int MODE>
__device__ __forceinline__ void epilogue(const MoeArgs& g, const Tile& tl, const float (&acc)[64],
                                         int lr, int lc, int lane) {
  const int E = g.E, F = g.F;
  if constexpr (MODE == GATE_UP) {
    // columns 0-63 of the tile are gate rows n0/2 .. n0/2 + 63, 64-127 the same up rows
    bf16* gu = (bf16*)g.out0;
    bf16* act = (bf16*)g.out1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t r = (size_t)(tl.m0 + lr + 8 * h);
      bf16* gr = gu + r * 2 * F + tl.n0;
      bf16* ar = act + r * F + tl.n0 / 2;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int c = 8 * jb + lc;
        const uint32_t gp = hp::pack_bf16(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
        const uint32_t up = hp::pack_bf16(acc[4 * jb + 32 + 2 * h], acc[4 * jb + 33 + 2 * h]);
        *reinterpret_cast<uint32_t*>(gr + c) = gp;
        *reinterpret_cast<uint32_t*>(gr + 64 + c) = up;
        const float2 gv = unpack_bf16(gp), uv = unpack_bf16(up);
        store_pair(ar + c, silu(gv.x) * uv.x, silu(gv.y) * uv.y);
      }
    }
  } else if constexpr (MODE == DOWN) {
    float* ys = (float*)g.out0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t r = (size_t)(tl.m0 + lr + 8 * h);
      const float w = g.ws[r];
      float* yr = ys + r * E + tl.n0;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
        *reinterpret_cast<float2*>(yr + 8 * jb + lc) =
            make_float2(w * acc[4 * jb + 2 * h], w * acc[4 * jb + 2 * h + 1]);
    }
  } else if constexpr (MODE == DACT) {
    // acc = dout's rows . W2 (G); columns f = n0 + 8 jb + lc of F
    bf16* dgu = (bf16*)g.out0;
    bf16* aw = (bf16*)g.out1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t r = (size_t)(tl.m0 + lr + 8 * h);
      const float w = g.ws[r];
      const bf16* gr = g.gu + r * 2 * F;
      bf16* dr = dgu + r * 2 * F;
      bf16* awr = aw + r * F;
      float part = 0.0f;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb) {
        const int f = tl.n0 + 8 * jb + lc;
        const int gc = 2 * (f & ~63) + (f & 63);  // f's gate column in the interleaved gu
        const float2 gv = bf16_pair(gr + gc), uv = bf16_pair(gr + gc + 64);
        const float G0 = acc[4 * jb + 2 * h], G1 = acc[4 * jb + 2 * h + 1];
        const float s0 = silu(gv.x), s1 = silu(gv.y);
        const float a0 = bf16_round(s0 * uv.x), a1 = bf16_round(s1 * uv.y);
        part = fmaf(G0, a0, part);
        part = fmaf(G1, a1, part);
        const float sg0 = 1.0f / (1.0f + expf(-gv.x)), sg1 = 1.0f / (1.0f + expf(-gv.y));
        const float d0 = w * G0, d1 = w * G1;
        store_pair(dr + gc, d0 * uv.x * sg0 * (1.0f + gv.x * (1.0f - sg0)),
                   d1 * uv.y * sg1 * (1.0f + gv.y * (1.0f - sg1)));
        store_pair(dr + gc + 64, d0 * s0, d1 * s1);
        store_pair(awr + f, w * a0, w * a1);
      }
      // the row's partial over this tile's 128 columns: the four lanes of the row, in order
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if ((lane & 3) == 0) g.part[r * (F / kBN) + tl.n0 / kBN] = part;
    }
  } else if constexpr (MODE == DX) {
    bf16* dx = (bf16*)g.out0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bf16* xr = dx + (size_t)(tl.m0 + lr + 8 * h) * E + tl.n0;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
        store_pair(xr + 8 * jb + lc, acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = dw_row<MODE>(g, tl, lr + 8 * h);
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
        *reinterpret_cast<float2*>(row + tl.n0 + 8 * jb + lc) =
            make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
    }
  }
}

template <int MODE>
__device__ __forceinline__ int steps_of(const MoeArgs& g, const int* offs, int t) {
  if constexpr (by_rows(MODE)) {
    return g.K / kBK;
  } else {
    const int e = t / (g.mt * g.nt);
    return (offs[e + 1] - offs[e]) / kBK;
  }
}

template <int MODE>
__device__ __forceinline__ int tiles_of(const MoeArgs& g, const int* offs) {
  return by_rows(MODE) ? offs[g.n] / kBM * g.nt : g.n * g.mt * g.nt;
}

// Thread 0's loader: K step k of tile t of this block's sequence is the next
// to load. Loads it into stage s, if there is one, and moves on.
template <int MODE>
__device__ __forceinline__ void load_next(int& t, int& k, int s, const MoeMaps& maps,
                                          const MoeArgs& g, const int* offs, uint32_t ring) {
  const int tiles = tiles_of<MODE>(g, offs);
  while (t < tiles && k >= steps_of<MODE>(g, offs, t)) t += gridDim.x, k = 0;
  if (t < tiles) {
    load_step<MODE>(maps, tile_of<MODE>(g, offs, t), k, ring + s * kStage, ring + kBars + 8 * s);
    ++k;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    moe_gemm_kernel(const __grid_constant__ MoeMaps maps, const MoeArgs g) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int offs[kMaxExperts + 1];
  const uint32_t ring = hp::smem_u32(hp::align_1024(smem_raw));
  const uint32_t full = ring + kBars, empty = full + 8 * kStages;
  for (int i = threadIdx.x; i <= g.n; i += kThreads) offs[i] = g.poff[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, kWarps);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  int lt = blockIdx.x, lk = 0;  // thread 0's loader
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) load_next<MODE>(lt, lk, s, maps, g, offs, ring);

  const int wg = threadIdx.x >> 7;
  int step = 0;  // steps this block has consumed
  // every warp lets go of consumed step `done`; thread 0 then refills its stage
  auto release = [&](int done) {
    const int sp = done % kStages;
    if ((threadIdx.x & 31) == 0) hp::mbar_arrive(empty + 8 * sp);
    if (threadIdx.x == 0) {
      hp::mbar_wait(empty + 8 * sp, (done / kStages) & 1);
      load_next<MODE>(lt, lk, sp, maps, g, offs, ring);
    }
    __syncwarp();
  };
  for (int t = blockIdx.x; t < tiles_of<MODE>(g, offs); t += gridDim.x) {
    const int nk = steps_of<MODE>(g, offs, t);
    if (!by_rows(MODE) && nk == 0) {
      zero_tile<MODE>(g, tile_of<MODE>(g, offs, t));
      continue;
    }
    float acc[kBN / 2];
    for (int kt = 0; kt < nk; ++kt, ++step) {
      const int s = step % kStages;
      hp::mbar_wait(full + 8 * s, (step / kStages) & 1);
      const uint32_t As = ring + s * kStage + wg * kHalf, Bs = ring + s * kStage + kOperand;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = a_mn(MODE) ? hp::desc_mn_major<kSw>(As + kk * 16 * kSw, kHalf)
                                       : hp::desc_k_major<kSw>(As + kk * 32);
        const uint64_t db = b_mn(MODE) ? hp::desc_mn_major<kSw>(Bs + kk * 16 * kSw, kHalf)
                                       : hp::desc_k_major<kSw>(Bs + kk * 32);
        mma<a_mn(MODE), b_mn(MODE)>(acc, da, db, (kt | kk) != 0);
      }
      hp::wgmma_commit();
      if (kt > 0) {  // the previous step's products are done: its stage is free
        hp::wgmma_wait<1>();
        release(step - 1);
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    release(step - 1);
    const int lane = threadIdx.x & 31;
    const int lr = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), lc = (lane & 3) * 2;
    epilogue<MODE>(g, tile_of<MODE>(g, offs, t), acc, lr, lc, lane);
  }
}

// ------------------------------------------------------------ row kernels

struct ExpertWeights {
  const float* gate[kMaxExperts];
  const float* up[kMaxExperts];
  const float* down[kMaxExperts];
};

// W1s[e] row 128 b + i = gate (i < 64) or up row 64 b + i % 64; W2s[e] = down; bf16.
__global__ void __launch_bounds__(256) moe_cast_kernel(const ExpertWeights w, int n, int E,
                                                       int F, bf16* w1s, bf16* w2s) {
  const long long per1 = 2LL * F * E / 4, per = per1 + (long long)E * F / 4;
  const long long total = n * per;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int e = (int)(i / per);
    const long long j = i - e * per;
    const float* src;
    bf16* dst;
    if (j < per1) {
      const long long el = 4 * j;
      const int row = (int)(el / E), col = (int)(el - (long long)row * E), q = row & 127;
      src = (q < 64 ? w.gate[e] : w.up[e]) + ((size_t)(row >> 7) * 64 + (q & 63)) * E + col;
      dst = w1s + (size_t)e * 2 * F * E + el;
    } else {
      const long long el = 4 * (j - per1);
      src = w.down[e] + el;
      dst = w2s + (size_t)e * E * F + el;
    }
    const float4 v = *reinterpret_cast<const float4*>(src);
    *reinterpret_cast<uint2*>(dst) = make_uint2(hp::pack_bf16(v.x, v.y), hp::pack_bf16(v.z, v.w));
  }
}

// One warp a row of the padded sorted order: xs[r] = h[token] (zeros on a
// padding row), ws[r] = its routing weight (0), dys[r] = bf16(dout[token]).
__global__ void __launch_bounds__(256) moe_gather_kernel(
    const bf16* h, const float* weights, const float* dout, const int* entry, const int* counts,
    const int* poff, int n, int k, int E, bf16* xs, float* ws, bf16* dys) {
  __shared__ int offs[kMaxExperts + 1], cnt[kMaxExperts];
  for (int i = threadIdx.x; i <= n; i += blockDim.x) {
    offs[i] = poff[i];
    if (i < n) cnt[i] = counts[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = gridDim.x * (blockDim.x >> 5);
  for (int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); r < offs[n]; r += warps) {
    int e = 0;
    while (offs[e + 1] <= r) ++e;
    const bool real = r - offs[e] < cnt[e];
    const int i = real ? entry[r] : 0;
    const size_t src = (size_t)(i / k) * E, dst = (size_t)r * E;
    for (int c = lane * 8; c < E; c += 256) {
      if (xs)
        *reinterpret_cast<uint4*>(xs + dst + c) =
            real ? *reinterpret_cast<const uint4*>(h + src + c) : make_uint4(0, 0, 0, 0);
      if (dys) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (real) {
          const float4 a = *reinterpret_cast<const float4*>(dout + src + c);
          const float4 b = *reinterpret_cast<const float4*>(dout + src + c + 4);
          v = make_uint4(hp::pack_bf16(a.x, a.y), hp::pack_bf16(a.z, a.w),
                         hp::pack_bf16(b.x, b.y), hp::pack_bf16(b.z, b.w));
        }
        *reinterpret_cast<uint4*>(dys + dst + c) = v;
      }
    }
    if (ws && lane == 0) ws[r] = real ? weights[i] : 0.0f;
  }
}

// Token t's rows (pos[t k + s], −1 where the choice is not held) in
// ascending order, which is ascending expert, into p[0 .. m); → m. Unrolled
// over kMaxK, so p stays in registers.
__device__ __forceinline__ int sorted_rows(const int* pos, int k, int (&p)[kMaxK]) {
  int last = -1, m = 0;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    int q = INT_MAX;
    for (int s = 0; s < k; ++s) {
      const int v = pos[s];
      q = v > last && v < q ? v : q;
    }
    p[j] = q;
    if (q != INT_MAX) last = q, ++m;
  }
  return m;
}

// One warp a token: out[t] = sum of ys over its rows, ascending, from 0.
__global__ void __launch_bounds__(256) moe_combine_kernel(const float* ys, const int* pos, int T,
                                                          int k, int E, float* out) {
  const int lane = threadIdx.x & 31, warps = gridDim.x * (blockDim.x >> 5);
  for (int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); t < T; t += warps) {
    int p[kMaxK];
    const int m = sorted_rows(pos + (size_t)t * k, k, p);
    for (int c = lane * 4; c < E; c += 128) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j >= m) break;
        const float4 v = *reinterpret_cast<const float4*>(ys + (size_t)p[j] * E + c);
        a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
      }
      *reinterpret_cast<float4*>(out + (size_t)t * E + c) = a;
    }
  }
}

// One warp a token: dh[t] = bf16(sum of dxs over its rows, ascending, in f32)
// (where dh is wanted) and dweights[t, s] = the sum of its row's partials in
// column-tile order (0 where the choice is not held).
__global__ void __launch_bounds__(256) moe_token_grad_kernel(
    const bf16* dxs, const float* part, const int* pos, int T, int k, int E, int nt, bf16* dh,
    float* dweights) {
  const int lane = threadIdx.x & 31, warps = gridDim.x * (blockDim.x >> 5);
  for (int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); t < T; t += warps) {
    if (lane < k) {
      const int q = pos[(size_t)t * k + lane];
      float d = 0.0f;
      if (q >= 0)
        for (int j = 0; j < nt; ++j) d += part[(size_t)q * nt + j];
      dweights[(size_t)t * k + lane] = d;
    }
    if (!dh) continue;
    int p[kMaxK];
    const int m = sorted_rows(pos + (size_t)t * k, k, p);
    for (int c = lane * 8; c < E; c += 256) {
      float a[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j >= m) break;
        const uint4 v = *reinterpret_cast<const uint4*>(dxs + (size_t)p[j] * E + c);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = unpack_bf16(u[q]);
          a[2 * q] += f.x, a[2 * q + 1] += f.y;
        }
      }
      *reinterpret_cast<uint4*>(dh + (size_t)t * E + c) =
          make_uint4(hp::pack_bf16(a[0], a[1]), hp::pack_bf16(a[2], a[3]),
                     hp::pack_bf16(a[4], a[5]), hp::pack_bf16(a[6], a[7]));
    }
  }
}

// ------------------------------------------------------------------ host

int row_grid(long long work) {
  const long long most = (long long)hp::sm_count() * 8;
  return (int)(work < 1 ? 1 : work < most ? work : most);
}

// A [rows, cols] bf16 matrix with dense rows as a two-axis map of [box_rows][64] boxes.
int make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {kBK, (uint32_t)box_rows};
  return hp::make_tensor_map_bf16<kSw>(map, base, 2, dims, strides, box);
}

template <int MODE>
int launch_gemm(const void* a, int a_rows, int a_cols, const void* b, int b_rows, int b_cols,
                MoeArgs g, int tiles, cudaStream_t st) {
  static const int allowed = (int)cudaFuncSetAttribute(
      moe_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (allowed != 0) return allowed;
  MoeMaps maps;
  if (int e = make_map(&maps.a, a, a_rows, a_cols, a_mn(MODE) ? 64 : kBM)) return e;
  if (int e = make_map(&maps.b, b, b_rows, b_cols, b_mn(MODE) ? 64 : kBN)) return e;
  const int most = hp::sm_count() * kBlocksPerSM;
  moe_gemm_kernel<MODE><<<tiles < most ? tiles : most, kThreads, kSmem, st>>>(maps, g);
  SMM_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace smm

using namespace smm;

// ptrs: the n held experts' f32 gate [F, E], then up [F, E], then down
// [E, F] weights (3n pointers, 16-byte aligned); w1s [n, 2F, E], w2s [n, E,
// F] bf16. E and F multiples of 128, n <= 64.
extern "C" int smm_moe_cast(const void* const* ptrs, int n, int E, int F, void* w1s, void* w2s,
                            void* stream) {
  if (n < 1 || n > kMaxExperts) return (int)cudaErrorInvalidValue;
  ExpertWeights w;
  for (int e = 0; e < n; ++e) {
    w.gate[e] = (const float*)ptrs[e];
    w.up[e] = (const float*)ptrs[n + e];
    w.down[e] = (const float*)ptrs[2 * n + e];
  }
  moe_cast_kernel<<<row_grid(3LL * n * E * F / 4 / 256), 256, 0, (cudaStream_t)stream>>>(
      w, n, E, F, (bf16*)w1s, (bf16*)w2s);
  SMM_CHECK_LAUNCH();
  return 0;
}

// Rows [0, poff[n]) of the padded sorted order (rows: the buffers' rows,
// the bound): xs and ws where not null (ws from weights [T, k] f32), dys
// from dout [T, E] f32 where not null. entry[r] = t k + s of a real row;
// counts [n], poff [n + 1] int32 on the device.
extern "C" int smm_moe_gather(const void* h, const float* weights, const float* dout,
                              const int* entry, const int* counts, const int* poff, int n, int k,
                              int E, int rows, void* xs, float* ws, void* dys, void* stream) {
  moe_gather_kernel<<<row_grid(rows / 8), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)h, weights, dout, entry, counts, poff, n, k, E, (bf16*)xs, ws, (bf16*)dys);
  SMM_CHECK_LAUNCH();
  return 0;
}

// One product of the layer (Mode), its operands and outputs as the top of
// this file names them: a, b (bf16), gu and ws where the mode reads them,
// out0, out1 and part where it writes them. rows: the per-row buffers' rows
// (a multiple of 128); poff [n + 1] int32 on the device.
extern "C" int smm_moe_gemm(int mode, const void* a, const void* b, const void* gu,
                            const float* ws, void* out0, void* out1, float* part, const int* poff,
                            int n, int rows, int E, int F, void* stream) {
  if (n < 1 || n > kMaxExperts || E % kBN || F % kBN || rows % kBM)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  MoeArgs g{poff, n, E, F, 0, 0, 0, 0, (const bf16*)gu, ws, out0, out1, part};
  const int strips = rows / kBM;
  switch (mode) {
    case GATE_UP:
      g.K = E, g.nt = 2 * F / kBN, g.b_rows = 2 * F;
      return launch_gemm<GATE_UP>(a, rows, E, b, n * 2 * F, E, g, strips * g.nt, st);
    case DOWN:
      g.K = F, g.nt = E / kBN, g.b_rows = E;
      return launch_gemm<DOWN>(a, rows, F, b, n * E, F, g, strips * g.nt, st);
    case DACT:
      g.K = E, g.nt = F / kBN, g.b_rows = E;
      return launch_gemm<DACT>(a, rows, E, b, n * E, F, g, strips * g.nt, st);
    case DX:
      g.K = 2 * F, g.nt = E / kBN, g.b_rows = 2 * F;
      return launch_gemm<DX>(a, rows, 2 * F, b, n * 2 * F, E, g, strips * g.nt, st);
    case DW1:
      g.mt = 2 * F / kBM, g.nt = E / kBN;
      return launch_gemm<DW1>(a, rows, 2 * F, b, rows, E, g, n * g.mt * g.nt, st);
    case DW2:
      g.mt = E / kBM, g.nt = F / kBN;
      return launch_gemm<DW2>(a, rows, E, b, rows, F, g, n * g.mt * g.nt, st);
  }
  return (int)cudaErrorInvalidValue;
}

// out [T, E] f32 from ys [rows, E] f32 and pos [T, k] int32.
extern "C" int smm_moe_combine(const float* ys, const int* pos, int T, int k, int E, float* out,
                               void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<row_grid(T / 8), 256, 0, (cudaStream_t)stream>>>(ys, pos, T, k, E, out);
  SMM_CHECK_LAUNCH();
  return 0;
}

// dh [T, E] bf16 (or null: dxs is then not read) from dxs [rows, E] bf16;
// dweights [T, k] f32 from part [rows, F / 128].
extern "C" int smm_moe_token_grad(const void* dxs, const float* part, const int* pos, int T,
                                  int k, int E, int F, void* dh, float* dweights, void* stream) {
  if (k < 1 || k > kMaxK || F % kBN) return (int)cudaErrorInvalidValue;
  moe_token_grad_kernel<<<row_grid(T / 8), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)dxs, part, pos, T, k, E, F / kBN, (bf16*)dh, dweights);
  SMM_CHECK_LAUNCH();
  return 0;
}

extern "C" int smm_moe_gemm_smem() { return kSmem; }
