"""The port's spans on the CPU at the tiny preset: one train step under
``torch.profiler`` opens each of the eight ``smm.*`` spans once, nested as
``portbench/spans.py`` reads them; ``annotate`` enters nothing without a
profiler; the backward nodes link by sequence number to the encoder spans
of their forward ops; evaluation and the demo carry the model's spans and
no step phase.
"""
import collections
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import spans, trace
from simple_multimodal_tpu_torch.config import ModelConfig
from simple_multimodal_tpu_torch.models.multimodal_model import create_model
from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo
from simple_multimodal_tpu_torch.train.optim import make_optimizer
from simple_multimodal_tpu_torch.train.state import TrainState
from simple_multimodal_tpu_torch.train.steps import make_eval_step, make_train_step
from simple_multimodal_tpu_torch.utils import profiling

B = 2
PHASE_SPANS = ("smm.train_step", "smm.forward", "smm.backward", "smm.optimizer")
MODEL_SPANS = ("smm.encode.text", "smm.encode.audio", "smm.encode.video", "smm.fuse")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The tiny hierarchical model (the sizes of ``conftest.tiny_config``),
    its train step and one batch."""
    base = tmp_path_factory.mktemp("spans")
    cfg = ModelConfig(text_max_length=16, audio_max_length=3200, video_max_frames=4,
                      video_frame_size=(32, 32), fusion_hidden_size=32, fusion_num_heads=4,
                      graph_hidden_size=16, adapter_size=8, prompt_length=4, batch_size=B,
                      encoder_preset="tiny", data_path=str(base / "data"),
                      save_path=str(base / "ckpt"), log_path=str(base / "logs"))
    cfg.fusion_type = "hierarchical"
    model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, make_optimizer(cfg, model, 10), cfg, augment=True)
    g = torch.Generator().manual_seed(1)
    batch = {"text": {"input_ids": torch.randint(1, 100, (B, 16), generator=g),
                      "attention_mask": torch.ones(B, 16, dtype=torch.long)},
             "audio": torch.randn(B, 3200, generator=g),
             "video": torch.randint(0, 256, (B, 4, 32, 32, 3), generator=g).to(torch.uint8),
             "emotion": torch.tensor([1, 4])}
    return cfg, model, step, batch


def _profile(fn):
    """fn() under the profiler inside the benchmark's window span → the
    profiler, and the host ops ``portbench/spans.py`` reads."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            fn()
    ops, _, window = spans.events(prof)
    assert window is not None
    return prof, ops


def _named(ops, names):
    return {n: [op for op in ops if op.name == n] for n in names}


def _inside(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end and inner.tid == outer.tid


def test_a_train_step_opens_each_span_once_nested(port):
    _, _, step, batch = port
    _, ops = _profile(lambda: step(TrainState.create(0), batch))
    found = _named(ops, PHASE_SPANS + MODEL_SPANS)
    assert {n: len(v) for n, v in found.items()} == dict.fromkeys(PHASE_SPANS + MODEL_SPANS, 1)
    (root,), (fwd,) = found["smm.train_step"], found["smm.forward"]
    for name in PHASE_SPANS[1:]:
        assert _inside(found[name][0], root), name
    for name in MODEL_SPANS:
        assert _inside(found[name][0], fwd), name
    bwd, opt = found["smm.backward"][0], found["smm.optimizer"][0]
    assert fwd.end <= bwd.start and bwd.end <= opt.start


def test_annotate_enters_nothing_without_a_profiler(port, monkeypatch):
    _, _, step, batch = port
    calls = []
    real = profiling.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    step(TrainState.create(0), batch)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        step(TrainState.create(0), batch)
    assert sorted(calls) == sorted(PHASE_SPANS + MODEL_SPANS)


def test_backward_nodes_link_to_the_encoder_spans_of_their_forward_ops(port):
    _, _, step, batch = port
    prof, ops = _profile(lambda: step(TrainState.create(0), batch))
    contexts = spans.contexts(ops)
    parts = spans.backward_parts(ops, contexts)
    nodes = [i for i, op in enumerate(ops) if op.name.startswith(spans.EVALUATE)]
    assert len(nodes) > 100 and set(parts) == set(nodes)
    count = collections.Counter(parts.values())
    for part in ("text", "audio", "video", "fusion"):
        assert count[part] >= 1, count
    # every node runs inside smm.backward, after the forward op that made it
    (bwd,) = _named(ops, ["smm.backward"])["smm.backward"]
    assert all(bwd.start <= ops[i].start <= bwd.end for i in nodes)
    # the whole reading of this profile: one step, all of its window idle
    # (no device), and no device time to share out
    ctx = types.SimpleNamespace(trace=trace.from_profiler(prof), info=[])
    spans.record(ctx, prof)
    assert ctx.spans["steps"] == 1 and ctx.spans["device_total"] == 0
    assert ctx.spans["idle_total"] == pytest.approx(ctx.trace["window_s"])
    assert ctx.info[0].startswith("program spans: 1 traced steps; device idle a step (ms): forward")
    assert spans.per_step_ms(ctx, "idle", "forward") is None


@pytest.mark.parametrize("path", ["eval_step", "predict"])
def test_eval_and_predict_carry_the_model_spans_and_no_phase(port, path):
    cfg, model, _, batch = port
    if path == "eval_step":
        fn = lambda: make_eval_step(model)(batch)  # noqa: E731
    else:
        demo = MultimodalEmotionDemo(model=model, config=cfg, device="cpu")
        fn = lambda: demo.predict("so happy today")  # noqa: E731
    _, ops = _profile(fn)
    found = _named(ops, PHASE_SPANS + MODEL_SPANS)
    assert {n: len(v) for n, v in found.items()} == {
        **dict.fromkeys(PHASE_SPANS, 0), **dict.fromkeys(MODEL_SPANS, 1)}
