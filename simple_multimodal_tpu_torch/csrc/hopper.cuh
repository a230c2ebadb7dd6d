// Hopper (sm_90a) building blocks shared by the port's kernels: warpgroup
// matrix multiply (wgmma) with its shared-memory descriptors, mbarriers, TMA
// tile loads with the host-side tensor-map constructor, and the swizzle the
// shared-memory tiles use. Nothing here knows what a kernel computes.
//
// Conventions every helper assumes:
// - bf16 operands, f32 accumulators. One warpgroup = 4 consecutive warps
//   whose first warp index is a multiple of 4; every wgmma wrapper must be
//   reached by all 128 threads of the warpgroup together.
// - A shared-memory operand tile is stored as TMA writes it with a swizzle
//   of SW bytes (32, 64 or 128): rows of SW bytes (SW/2 bf16 columns: one
//   "atom" column block), 8 rows = one 8*SW-byte swizzle pattern, rows
//   dense. A tile wider than one atom is a sequence of such [rows][SW]
//   blocks. Every block starts on a multiple of 8*SW bytes (1024 covers
//   all), so the descriptor's base offset is 0.
// - The accumulator of an m64nNk16 product holds, in thread t of the
//   warpgroup (warp w = t/32 % 4, lane l = t%32), for each 8-column block j:
//   d[4j+0], d[4j+1] = row 16w + l/4,     columns 8j + 2(l%4), +1
//   d[4j+2], d[4j+3] = row 16w + l/4 + 8, the same columns.
//   Packed pairwise to bf16 (pack(d[2n], d[2n+1]) for n = 4kk .. 4kk+3)
//   these are the four A registers of k16 step kk of a following product:
//   an accumulator feeds the next wgmma without leaving registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled itself is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smm {
namespace hopper {

// ------------------------------------------------------------------ swizzle

// Byte offset inside a tile block whose rows are SW bytes wide -> where TMA
// (CU_TENSOR_MAP_SWIZZLE_{32,64,128}B) put that byte: the 16-byte chunk
// index is XORed with the row's position in its 8*SW-byte pattern (address
// bits [7, 7 + log2(SW/16)) into bits [4, ...)). Assumes the block starts on
// a multiple of 8*SW bytes.
template <int SW>
__host__ __device__ __forceinline__ uint32_t swizzle_offset(uint32_t off) {
  static_assert(SW == 32 || SW == 64 || SW == 128, "swizzle width");
  constexpr uint32_t mask = SW / 16 - 1;  // 1, 3 or 7
  return off ^ (((off >> 7) & mask) << 4);
}

// layout_type codes of the wgmma shared-memory descriptor, by swizzle width
template <int SW>
struct SwizzleCode;
template <>
struct SwizzleCode<128> { static constexpr uint64_t value = 1; };
template <>
struct SwizzleCode<64> { static constexpr uint64_t value = 2; };
template <>
struct SwizzleCode<32> { static constexpr uint64_t value = 3; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------ wgmma descriptors

// The 64-bit matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units, 14 bits each) and the swizzle code.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint64_t code) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFFu) << 32) | (code << 62);
}

// K-major operand (A, or B with trans-b = 0): the contraction axis runs
// along a tile row. `addr` = shared address of element (first row of the
// operand, first of the 16 contraction columns of this k16 step); inside
// an atom block a k16 step is 32 bytes further along the row, the next atom
// block holds the next SW/2 columns. The operand's M or N rows follow in
// groups of 8 at 8*SW bytes (the stride offset); the leading offset is
// unused with a swizzle (set to 1 unit).
template <int SW>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 8 * SW, SwizzleCode<SW>::value);
}

// MN-major B operand (trans-b = 1): the contraction axis runs down the tile
// rows, the N axis along them ([k][n] in memory, e.g. a [token][d] tile
// contracted over tokens). `addr` = shared address of (row = first of the
// 16 contraction rows of this k16 step, column 0): a k16 step is 16 rows =
// 16*SW bytes further. N walks along a row for SW/2 columns, then jumps
// `atom_stride_bytes` to the next atom block (the leading offset); the
// second group of 8 contraction rows lies 8*SW bytes on (the stride offset).
template <int SW>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t atom_stride_bytes) {
  return smem_desc(addr, atom_stride_bytes, 8 * SW, SwizzleCode<SW>::value);
}

// Either operand in the no-swizzle (interleaved) layout: a core matrix is 8
// rows of 16 bytes stored as 128 contiguous bytes, so `addr` needs only
// 16-byte alignment and a shift by one row is a shift of 16 bytes. K-major:
// `k_stride_bytes` = from one 8-column core matrix to the next along the
// contraction (the leading offset), `row_stride_bytes` = from one 8-row
// group to the next (the stride offset).
__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr, uint32_t k_stride_bytes,
                                                    uint32_t row_stride_bytes) {
  return smem_desc(addr, k_stride_bytes, row_stride_bytes, 0);
}

// ------------------------------------------------------------ wgmma control

// Before the first wgmma of a batch, and after any thread-side write to
// accumulator or A registers that a wgmma will read.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most PENDING committed groups are still in flight. The
// accumulators of a group must not be touched before its wait.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Pins accumulator registers at this point of the program, so the compiler
// moves no use or copy of them across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Two f32 -> one register of two bf16 (round to nearest even), the first in
// the low half: the A-register form of a pair of accumulator columns.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Register rebalancing between the warpgroups of a block: a warpgroup that
// only issues copies gives registers back (`dec`), the ones that hold
// accumulators take them (`inc`). Every warp of the warpgroup must execute
// it, at the top of a branch the warpgroup never leaves; N is a multiple of
// 8 in [24, 256], and the block's total must fit the 64 K registers of an
// SM: with three warpgroups launched at 168 registers, 40 + 2 * 232.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------- wgmma m64nNk16, bf16 -> f32
//
// d (+)= A . B for one k16 step; scale_d = 0 overwrites d (no zeroing
// needed), 1 accumulates. `_ss`: A and B from shared memory (A K-major);
// `_rs`: A from four registers per thread (the fragment described at the top
// of this file). TB = 0: B K-major; TB = 1: B MN-major. Asynchronous: fence
// before, commit and wait after.

#define SMM_ACC8(d, o)                                                                  \
  "+f"((d)[o]), "+f"((d)[o + 1]), "+f"((d)[o + 2]), "+f"((d)[o + 3]), "+f"((d)[o + 4]), \
      "+f"((d)[o + 5]), "+f"((d)[o + 6]), "+f"((d)[o + 7])
#define SMM_ACC8A(d) SMM_ACC8(d, 0)
#define SMM_ACC16(d) SMM_ACC8(d, 0), SMM_ACC8(d, 8)
#define SMM_ACC24(d) SMM_ACC16(d), SMM_ACC8(d, 16)
#define SMM_ACC32(d) SMM_ACC16(d), SMM_ACC8(d, 16), SMM_ACC8(d, 24)
#define SMM_ACC48(d) SMM_ACC32(d), SMM_ACC8(d, 32), SMM_ACC8(d, 40)
#define SMM_ACC64(d) SMM_ACC48(d), SMM_ACC8(d, 48), SMM_ACC8(d, 56)
#define SMM_REG8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define SMM_REG16 SMM_REG8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define SMM_REG24 SMM_REG16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define SMM_REG32 \
  SMM_REG16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SMM_REG48 \
  SMM_REG32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define SMM_REG64 \
  SMM_REG48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// P0.. = the operand numbers that follow the N/2 accumulator registers.
#define SMM_DEFINE_WGMMA(N, REGS, ACC, P0, P1, P2, P3, P4, P5, P6)                              \
  template <int TB>                                                                             \
  __device__ __forceinline__ void wgmma_ss_n##N(float (&d)[N / 2], uint64_t desc_a,             \
                                                uint64_t desc_b, int scale_d) {                 \
    asm volatile(                                                                               \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P2 ", 0;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, %" #P0 ", %" #P1  \
        ", p, 1, 1, 0, %" #P3 ";\n}\n"                                                          \
        : ACC(d)                                                                                \
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TB));                                     \
  }                                                                                             \
  template <int TB>                                                                             \
  __device__ __forceinline__ void wgmma_rs_n##N(float (&d)[N / 2], uint32_t a0, uint32_t a1,    \
                                                uint32_t a2, uint32_t a3, uint64_t desc_b,      \
                                                int scale_d) {                                  \
    asm volatile(                                                                               \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P5 ", 0;\n"                                       \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, {%" #P0 ", %" #P1 \
        ", %" #P2 ", %" #P3 "}, %" #P4 ", p, 1, 1, %" #P6 ";\n}\n"                              \
        : ACC(d)                                                                                \
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d), "n"(TB));              \
  }

SMM_DEFINE_WGMMA(16, SMM_REG8, SMM_ACC8A, 8, 9, 10, 11, 12, 13, 14)
SMM_DEFINE_WGMMA(32, SMM_REG16, SMM_ACC16, 16, 17, 18, 19, 20, 21, 22)
SMM_DEFINE_WGMMA(48, SMM_REG24, SMM_ACC24, 24, 25, 26, 27, 28, 29, 30)
SMM_DEFINE_WGMMA(64, SMM_REG32, SMM_ACC32, 32, 33, 34, 35, 36, 37, 38)
SMM_DEFINE_WGMMA(96, SMM_REG48, SMM_ACC48, 48, 49, 50, 51, 52, 53, 54)
SMM_DEFINE_WGMMA(128, SMM_REG64, SMM_ACC64, 64, 65, 66, 67, 68, 69, 70)

#undef SMM_DEFINE_WGMMA

template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96 || N == 128,
                "wgmma width not instantiated");
  if constexpr (N == 16) wgmma_ss_n16<TB>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 32) wgmma_ss_n32<TB>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 48) wgmma_ss_n48<TB>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<TB>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 96) wgmma_ss_n96<TB>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_ss_n128<TB>(d, desc_a, desc_b, scale_d);
}

// `a` = the four A registers of this k16 step (a[0..3]).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 96 || N == 128, "wgmma width not instantiated");
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a[0], a[1], a[2], a[3], desc_b, scale_d);
  if constexpr (N == 96) wgmma_rs_n96<TB>(d, a[0], a[1], a[2], a[3], desc_b, scale_d);
  if constexpr (N == 128) wgmma_rs_n128<TB>(d, a[0], a[1], a[2], a[3], desc_b, scale_d);
}

// ---------------------------------------------------------------- mbarrier
//
// A 64-bit barrier in shared memory (8-byte aligned), addressed by its
// 32-bit shared address. A phase completes when `count` arrivals have come
// and every byte announced with expect_tx has landed; phases alternate
// parity 0, 1, 0, ... from the first.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// After the inits by one thread and before a __syncthreads(): makes the
// barriers visible to the asynchronous (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of asynchronous copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// True once the phase of this parity has completed.
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spins until the phase of this parity has completed. A copy that never
// lands (a wrong byte count, a bad tensor map) would spin forever: after
// 2^26 polls, seconds of waiting, the kernel traps and the launch reports
// an error instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls > (1u << 26)) __trap();
}

// --------------------------------------------------------------------- TMA

// One thread copies the tensor map's box at these coordinates (innermost
// first, in elements) into shared memory at `dst` (aligned to the swizzle
// pattern, see the top of this file); the whole box's bytes are counted on
// `bar` when they have landed, and elements outside the tensor arrive as
// zeros. The map must be a `const __grid_constant__ CUtensorMap` kernel
// parameter (or live in global or constant memory).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One thread copies `bytes` (a multiple of 16; both addresses 16-byte
// aligned) of contiguous device memory into shared memory at `dst`, counted
// on `bar` when they have landed: TMA's one-dimensional form, no tensor map.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------ host: device

// The current device's multiprocessor count, read once (132 where it cannot
// be read): persistent grids size themselves by it.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return sms;
  }();
  return n;
}

// ------------------------------------------------------- host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the loaded libcuda through the
// runtime (the library does not link it); null if it has none.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    return (EncodeTiledFn)p;
  }();
  return fn;
}

template <int SW>
struct SwizzleEnum;
template <>
struct SwizzleEnum<128> { static constexpr CUtensorMapSwizzle value = CU_TENSOR_MAP_SWIZZLE_128B; };
template <>
struct SwizzleEnum<64> { static constexpr CUtensorMapSwizzle value = CU_TENSOR_MAP_SWIZZLE_64B; };
template <>
struct SwizzleEnum<32> { static constexpr CUtensorMapSwizzle value = CU_TENSOR_MAP_SWIZZLE_32B; };

// A tiled bf16 tensor map of `rank` (2..5) axes, innermost first: `dims` in
// elements, `strides_bytes[i]` = byte stride of axis i + 1 (axis 0 is
// dense), `box` = the tile one load copies. The encoder requires: base
// 16-byte aligned, every stride a multiple of 16 bytes, box[0] * 2 bytes
// <= SW and a multiple of 16, every box extent <= 256. Out-of-range
// elements load as zeros. Returns 0, or a cudaError_t.
template <int SW>
inline int make_tensor_map_bf16(CUtensorMap* map, const void* base, int rank,
                                const uint64_t* dims, const uint64_t* strides_bytes,
                                const uint32_t* box) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (!encode) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides_bytes[i];
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<void*>(base), gdim, gstride, gbox, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, SwizzleEnum<SW>::value,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The first byte at or after `p` that is a multiple of 1024: dynamic shared
// memory is only guaranteed 16-byte alignment, tiles need their swizzle
// pattern's (ask for 1024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

}  // namespace hopper
}  // namespace smm
