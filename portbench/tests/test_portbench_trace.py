"""The idle, family and roofline arithmetic on synthetic traces."""
import types

import pytest

from portbench import flops, trace
from portbench.metrics import _shared

MS = 1_000_000  # ns


def test_busy_is_the_union_of_device_intervals():
    device = [(0, 4 * MS, "gemm_wgmma_kernel"), (2 * MS, 6 * MS, "ncclKernel_AllReduce"),
              (8 * MS, 9 * MS, "Memcpy HtoD")]
    s = trace.summarize(device, [(5 * MS, 9 * MS, "aten::copy_")], (0, 10 * MS))
    assert s["busy_s"] == pytest.approx(0.007)
    assert s["window_s"] == pytest.approx(0.010)
    assert [g for g in s["gaps"]] == [("aten::copy_", pytest.approx(0.002)),
                                      ("host idle", pytest.approx(0.001))]
    ctx = types.SimpleNamespace(trace=s)
    assert _shared.idle_pct(ctx) == pytest.approx(30.0)


def test_window_clips_intervals():
    s = trace.summarize([(-5 * MS, 5 * MS, "k")], [], (0, 10 * MS))
    assert s["busy_s"] == pytest.approx(0.005)
    assert s["by_name"]["k"] == pytest.approx(0.005)


def test_innermost_host_op_labels_a_gap():
    host = [(0, 10 * MS, "portbench.step"), (1 * MS, 4 * MS, "aten::linear"),
            (2 * MS, 3 * MS, "cudaLaunchKernel")]
    s = trace.summarize([(0, 2500 * 1000, "k"), (6 * MS, 10 * MS, "k")], host, (0, 10 * MS))
    assert [lab for lab, _ in s["gaps"]] == ["cudaLaunchKernel"]


@pytest.mark.parametrize("name,fam", [
    ("gemm_wgmma_kernel", "gemm"), ("ffn_bwd_wgmma_kernel", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("cutlass3x_sm90_tensorop_gemm_bf16_bf16_f32", "gemm"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw", "conv"),
    ("flash_fwd_wgmma_kernel", "attention"), ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"), ("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_splitK_NTN", "gemm"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>", "norm"),
    ("some_unknown_kernel", "other")])
def test_families(name, fam):
    assert trace.family(name) == fam


@pytest.mark.parametrize("kernel", ["gemm_wgmma_kernel",
                                    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"])
def test_gemm_work_does_not_depend_on_the_kernel(kernel):
    """The same products read the same share whether the port's GEMM or a
    library's ran them: the work comes from the configuration."""
    s = trace.summarize([(0, 10 * MS, kernel)], [], (0, 20 * MS))
    ctx = types.SimpleNamespace(trace=s, work={"linear": 1e12}, traced_units=2)
    assert _shared.roofline_pct(ctx, "linear", "gemm") == pytest.approx(
        100 * 2e12 / flops.PEAK_FLOPS / 0.010)


def test_a_reader_with_nothing_to_read_returns_nothing():
    ctx = types.SimpleNamespace(trace=None, work=None, traced_units=0, latencies=None,
                                flops_done=0.0, window_s=None)
    assert _shared.idle_pct(ctx) is None
    assert _shared.roofline_pct(ctx, "conv", "conv") is None
    assert _shared.percentile_ms(ctx, 95) is None
    assert _shared.mfu_pct(ctx) is None
    s = trace.summarize([(0, MS, "gemm_wgmma_kernel")], [], (0, 2 * MS))
    assert _shared.roofline_pct(types.SimpleNamespace(trace=s, work={"conv": 1.0}, traced_units=1),
                                "conv", "conv") is None


def test_breakdown_keeps_ten_of_each():
    device = [(i * MS, i * MS + 1000, f"k{i}") for i in range(0, 40, 2)]
    host = [(i * MS + 500, i * MS + 3000, f"op{i}") for i in range(0, 40, 2)]
    b = trace.breakdown(trace.summarize(device, host, (0, 40 * MS)))
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) == 10
