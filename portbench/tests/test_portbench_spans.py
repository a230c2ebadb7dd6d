"""Idle by step phase and device time by model part on synthetic events."""
import types

import pytest

from portbench import spans, trace
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


# One step: the text encoder's addmm (sequence number 10) launches k_text;
# its backward node on the autograd thread launches k_text_bwd; AdamW
# launches k_adam; k_gather runs after the step, under no span. The
# launches' correlation ids (7xx) and the device's are one space.
OPS = [
    _op(0, 90, "smm.train_step"),
    _op(0, 40, "smm.forward"),
    _op(4, 5, "aten::zeros", seq=10),  # took 10 too, made no node
    _op(5, 15, "smm.encode.text"),
    _op(6, 8, "aten::addmm", seq=10),
    _launch(7, 700),
    _op(15, 30, "smm.encode.audio"),
    _op(16, 20, "aten::convolution", seq=11),
    _launch(17, 701),
    _op(40, 70, "smm.backward"),
    _op(45, 55, spans.EVALUATE + "AddmmBackward0", tid=AUTOGRAD, seq=10, fwd_tid=MAIN),
    _op(46, 47, "aten::mm", tid=AUTOGRAD),
    _launch(46.2, 703, tid=AUTOGRAD),
    _op(70, 88, "smm.optimizer"),
    _op(71, 72, "aten::_foreach_add_"),
    _launch(71.2, 702),
    _op(91, 92, "aten::index_select"),
    _launch(91.2, 704),
]
DEVICE = [
    _dev(8, 12, "k_text", 700),
    _dev(20, 30, "k_audio", 701),
    _dev(47, 60, "k_text_bwd", 703),
    _dev(72, 80, "k_adam", 702),
    _dev(92, 95, "k_gather", 704),
]


@pytest.fixture
def result():
    return spans.attribute(OPS, DEVICE, WINDOW)


def test_an_idle_gap_splits_across_two_phase_spans(result):
    # gaps: [0,8] [12,20] [30,47] [60,72] [80,92] [95,100]; [30,47] is
    # 10 ms of forward and 7 of backward, [60,72] 10 of backward and 2 of
    # the optimizer, [80,92] 8 of the optimizer and 4 outside the phases
    assert result["steps"] == 1
    assert result["idle"] == pytest.approx(
        {"forward": 0.026, "backward": 0.017, "optimizer": 0.010, "between": 0.009})
    s = trace.summarize([(d.start, d.end, d.name) for d in DEVICE], [], WINDOW)
    assert result["idle_total"] == pytest.approx(s["window_s"] - s["busy_s"])


def test_a_backward_kernel_links_through_its_node_to_the_encoder_span(result):
    assert result["parts"]["text"] == pytest.approx(0.004 + 0.013)
    assert result["parts"]["audio"] == pytest.approx(0.010)
    assert result["backward"] == [1, 1] and result["unlinked"] == 0
    ctxs = spans.contexts(OPS)
    node = next(i for i, op in enumerate(OPS) if op.name.startswith(spans.EVALUATE))
    assert spans.backward_parts(OPS, ctxs) == {node: "text"}


def test_device_time_outside_any_span_lands_in_other(result):
    assert result["parts"]["optimizer"] == pytest.approx(0.008)
    assert result["parts"]["other"] == pytest.approx(0.003)
    assert result["other"] == {"between": pytest.approx(0.003)}
    assert result["other_names"] == {"k_gather": pytest.approx(0.003)}


def test_the_partition_sums_to_the_by_name_total(result):
    s = trace.summarize([(d.start, d.end, d.name) for d in DEVICE], [], WINDOW)
    assert sum(result["parts"].values()) == pytest.approx(sum(s["by_name"].values()))
    assert result["device_total"] == pytest.approx(0.038)


def test_a_program_without_spans_gives_no_metric():
    bare = [op for op in OPS if not op.name.startswith("smm.")]
    assert spans.attribute(bare, DEVICE, WINDOW) is None
    ctx = types.SimpleNamespace(spans=None, info=[])
    assert spans.per_step_ms(ctx, "idle", "forward") is None
    assert spans.per_step_ms(types.SimpleNamespace(), "parts", "text") is None
    ctx.spans = spans.attribute(OPS, [], WINDOW)  # no card: idle, and nothing on a device
    assert ctx.spans["idle_total"] == pytest.approx(0.1)
    assert spans.per_step_ms(ctx, "idle", "forward") is None
    ctx.spans = spans.attribute(OPS, DEVICE, WINDOW)
    assert spans.per_step_ms(ctx, "parts", "audio") == pytest.approx(10.0)
