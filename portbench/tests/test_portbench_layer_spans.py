"""Device time by the program's layer spans (``layer_spans.py``) on
synthetic events, and the new metric readers on a run without them."""
import types

from portbench import layer_spans, spans
from portbench.spans import Dev, Op

MS = 1_000_000  # ns
MAIN, AUTOGRAD = 1, 2
WINDOW = (0, 100 * MS)


def _op(s, e, name, tid=MAIN, seq=-1, fwd_tid=0, launch=0):
    return Op(s * MS, e * MS, name, tid, seq, fwd_tid, launch)


def _launch(s, corr, tid=MAIN):
    return _op(s, s + 0.5, "cudaLaunchKernel", tid=tid, launch=corr)


def _dev(s, e, name, corr):
    return Dev(s * MS, e * MS, name, corr)


# One step: inside smm.encode.text, smm.mla's q projection (sequence number
# 10) launches a GEMM; smm.moe.experts launches a gather and a GEMM; the
# q projection's backward node launches a GEMM on the autograd thread; the
# mesh's all-reduce launches an NCCL kernel and a copy in smm.allreduce.
OPS = [
    _op(0, 90, "smm.train_step"),
    _op(0, 40, "smm.forward"),
    _op(1, 30, "smm.encode.text"),
    _op(2, 10, "smm.mla"),
    _op(3, 5, "_GemmLinear", seq=10),
    _launch(4, 800),
    _op(10, 20, "smm.moe.experts"),
    _launch(11, 801),
    _launch(12, 802),
    _op(40, 70, "smm.backward"),
    _op(45, 55, spans.EVALUATE + "_GemmLinearBackward", tid=AUTOGRAD, seq=10, fwd_tid=MAIN),
    _launch(46, 803, tid=AUTOGRAD),
    _op(60, 68, "smm.allreduce"),
    _launch(61, 804),
    _launch(62, 805),
    _launch(75, 806),
]
DEVICE = [
    _dev(5, 9, "gemm_wgmma_kernel", 800),
    _dev(12, 13, "indexSelectLargeIndex", 801),
    _dev(13, 17, "gemm_wgmma_kernel", 802),
    _dev(47, 53, "gemm_wgmma_kernel", 803),
    _dev(62, 66, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 804),
    _dev(66, 67, "direct_copy_kernel", 805),
    _dev(76, 80, "multi_tensor_apply_kernel", 806),
]


def _ctx():
    ctx = types.SimpleNamespace(info=[])
    ctx.layer_spans = layer_spans.attribute(OPS, DEVICE, WINDOW)
    return ctx


def test_parts_take_their_launches_and_their_backward_nodes():
    s = layer_spans.attribute(OPS, DEVICE, WINDOW)
    assert s["steps"] == 1 and s["seen"] == {"mla", "moe.experts", "allreduce"}
    assert s["by_part"]["mla"] == {"gemm": 0.010}  # 4 ms forward + 6 ms in its backward node
    assert s["by_part"]["moe.experts"] == {"elementwise": 0.001, "gemm": 0.004}
    assert s["by_part"]["allreduce"] == {"nccl": 0.004, "copy": 0.001}
    assert "optimizer" not in s["by_part"]


def test_per_step_ms_by_parts_and_family():
    ctx = _ctx()
    assert abs(layer_spans.per_step_ms(ctx, ["mla"]) - 10.0) < 1e-9
    assert abs(layer_spans.per_step_ms(ctx, ["moe.route", "moe.experts"]) - 5.0) < 1e-9
    assert abs(layer_spans.per_step_ms(ctx, ["allreduce"], family="nccl") - 4.0) < 1e-9
    assert layer_spans.per_step_ms(ctx, ["moe.shared"]) is None  # no such span: no number


def test_a_program_without_the_spans_reports_nothing():
    import importlib.util
    from pathlib import Path

    ops = [op for op in OPS if op.name not in layer_spans.PARTS]
    ctx = types.SimpleNamespace(info=[], layer_spans=layer_spans.attribute(ops, DEVICE, WINDOW),
                                counted=None, traced_units=1, cfg={})
    here = Path(__file__).resolve().parents[1] / "metrics"
    for name in ("mla_ms.train", "moe_ms.train", "moe_roofline", "allreduce_ms.dp"):
        spec = importlib.util.spec_from_file_location(name, here / f"{name}.py")
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
        assert reader.read(ctx) is None, name
    bare = types.SimpleNamespace(info=[])
    assert layer_spans.per_step_ms(bare, ["mla"]) is None
