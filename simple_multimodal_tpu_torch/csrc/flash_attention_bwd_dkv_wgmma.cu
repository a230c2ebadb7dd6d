// Flash attention backward on wgmma, the dk/dv kernel (bf16, head widths
// 64, 96, 128): dv = p^T dout and dk = ds^T q / sqrt(D).
//
// Replaces simple_multimodal_tpu/ops/pallas/flash_attention.py,
// `_bwd_dkv_kernel` via `_flash_backward`, for the widths the long-clip
// path uses; the arithmetic is that of flash_attention_bwd.cu (p and ds
// rounded to bf16 before they meet dout and q). The shared design is in
// flash_attention_wgmma.cuh.
//
// What bounds it on this card: operations (four products, 8 Sq Sk D FLOP
// per (batch, head), two of them also computed by the dq kernel: the price
// of owning every output tile in one block with no atomics). What the
// design does about it: the key rows are the M axis, so s^T = k.q^T and
// dp^T = v.dout^T come out with keys as accumulator rows, p^T and ds^T are
// formed in registers and are the A registers of dv += p^T.dout and
// dk += ds^T.q, with the streamed dout and Q tiles as MN-major B operands.
// One consumer warpgroup (64 key rows, K and V resident in shared memory)
// and a producer warp per block, 160 threads: dk and dv are two 64 x D
// accumulators (D registers a thread; 166 to 254 registers in all), so
// two or three such blocks share an SM at D = 64 and 96 and one block's
// exponentials overlap another's wgmma. (Two consumer warpgroups in one
// block, 232 registers each beside a producer warpgroup, spilled at D = 96
// and were no faster at D = 64.) The row statistics belong to the streamed
// queries, the accumulator's columns here: the producer warp writes the
// tile's m, 1/l and delta into the stage (1/l = 0 for a query past Sq or an
// empty row, so its p and ds are 0) and each thread reads its own columns'
// values as float2. The bias (key stride 1) is read with lanes along the
// keys: 8 consecutive keys of 4 queries per load, whole 32-byte sectors.

#include "flash_attention_bwd_dkv_wgmma.cuh"

namespace smm {
namespace {

using namespace flashw::dkv;

template <int D>
int launch_dkv_d(const FlashBwdArgs& a, int B, cudaStream_t st) {
  const Drop none{nullptr, 0, 1.0f};
  return a.f.bias ? launch_dkv<D, true, false>(a, none, B, st)
                  : launch_dkv<D, false, false>(a, none, B, st);
}

}  // namespace

int flash_bwd_dkv_wgmma_launch(const FlashBwdArgs& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch_dkv_d<64>(a, B, st);
    case 96: return launch_dkv_d<96>(a, B, st);
    case 128: return launch_dkv_d<128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int flash_bwd_dkv_wgmma_smem(int D) {
  return D == 64 ? DkvPlan<64>::bytes : D == 96 ? DkvPlan<96>::bytes : D == 128 ? DkvPlan<128>::bytes : 0;
}

}  // namespace smm
