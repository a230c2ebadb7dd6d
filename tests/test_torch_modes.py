"""The port's remaining training modes and its profiling module on the CPU,
at the tiny preset and the media sizes of tests/conftest.py:
``train_advanced_torch.py --mode distillation | ablation | all`` against
``train_advanced.py`` on the same argv (the JAX side run only as far as the
decision under test: its trainers are stubbed), and
``utils/profiling.py``.
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simple_multimodal_tpu import config as jconfig
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.models import multimodal_model as pmodel
from simple_multimodal_tpu_torch.models.multimodal_model import MultimodalEmotionModel
from simple_multimodal_tpu_torch.train import checkpoint
from simple_multimodal_tpu_torch.train import trainer as ptrainer
from simple_multimodal_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
TINY_MEDIA = dict(text_max_length=16, audio_max_length=3200, video_max_frames=4,
                  video_frame_size=(32, 32), fusion_hidden_size=32, fusion_num_heads=4,
                  graph_hidden_size=16, adapter_size=8, prompt_length=4)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cli = _load("train_advanced_torch", "train_advanced_torch.py")
jax_cli = _load("train_advanced", "train_advanced.py")
data_cli = _load("create_sample_data_torch", "create_sample_data_torch.py")


def _tiny_factory(cls, log_path):
    """``cls`` with the tiny media sizes as its defaults (a dataclass still,
    as the JAX CLI's ``config_from_dict`` needs)."""
    defaults = {**TINY_MEDIA, "log_path": log_path}
    return dataclasses.make_dataclass(
        "Tiny" + cls.__name__, [(k, type(v), dataclasses.field(default=v))
                                for k, v in defaults.items()], bases=(cls,))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("modes")
    data = data_cli.main(["--output_dir", str(root / "data" / "sample"), "--num_samples", "3"])
    return root, data


@pytest.fixture
def tiny_media(monkeypatch, workdir):
    """Both CLIs' ModelConfig at the tiny media sizes; no HF tokenizer lookup."""
    root, _ = workdir
    monkeypatch.setattr(cli, "ModelConfig", _tiny_factory(pconfig.ModelConfig,
                                                          str(root / "logs")))
    monkeypatch.setattr(jax_cli, "ModelConfig", _tiny_factory(jconfig.ModelConfig,
                                                              str(root / "logs")))
    monkeypatch.setitem(sys.modules, "transformers", None)
    return root


def _argv(root, data, save, *extra):
    return ["--device", "cpu", "--preset", "tiny", "--data_path", data,
            "--save_path", str(root / save), "--epochs", "1", "--batch_size", "4", *extra]


@pytest.fixture(scope="module")
def teacher(workdir):
    """An early-fusion teacher trained for one epoch by the port's CLI."""
    root, data = workdir
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "ModelConfig", _tiny_factory(pconfig.ModelConfig, str(root / "logs")))
        mp.setitem(sys.modules, "transformers", None)
        out = cli.main(_argv(root, data, "teacher", "--fusion_type", "early"))
    return out["path"]


class _Stop(Exception):
    pass


def _jax_student_config(monkeypatch, argv, teacher_fusion):
    """The student config of ``train_advanced.py --mode distillation`` for
    ``argv``: its run stops where the distillation model is built."""
    import simple_multimodal_tpu.models as jmodels
    import simple_multimodal_tpu.train.checkpoint as jckpt

    seen = {}

    def kd_model(teacher_config, student_config):
        seen.update(teacher=teacher_config, student=student_config)
        raise _Stop

    monkeypatch.setattr(jmodels, "KnowledgeDistillationModel", kd_model)
    monkeypatch.setattr(jckpt, "restore_checkpoint", lambda path: {
        "params": {}, "meta": {"config": {"fusion_type": teacher_fusion}}})
    monkeypatch.setattr(jax_cli, "load_datasets", lambda *a, **k: {})
    monkeypatch.setattr(sys, "argv", ["train_advanced.py", *argv])
    with pytest.raises(_Stop):
        jax_cli.main()
    return seen


def test_distillation_student_config_equals_jax(tiny_media, workdir, teacher, monkeypatch):
    root, data = workdir
    argv = _argv(root, data, "kd", "--mode", "distillation", "--teacher_model", teacher,
                 "--fusion_type", "hierarchical")
    out = cli.main(argv)
    student = out["trainer"].config
    jax_seen = _jax_student_config(monkeypatch, argv, "early")
    want = jconfig.config_to_dict(jax_seen["student"])
    got = pconfig.config_to_dict(student)
    assert {k: got[k] for k in want} == want
    # the teacher's fusion comes from its meta.json; the fusion stack is halved
    assert (student.fusion_type, student.fusion_hidden_size, student.fusion_num_heads,
            student.fusion_num_layers) == ("early", 16, 2, 2)
    teacher_cfg = pconfig.config_to_dict(out["trainer"].model.teacher.config)
    want = jconfig.config_to_dict(jax_seen["teacher"])
    assert {k: teacher_cfg[k] for k in want} == want
    assert (teacher_cfg["fusion_type"], teacher_cfg["fusion_hidden_size"]) == ("early", 32)


def test_distillation_teacher_bit_equal_and_student_saved_alone(tiny_media, workdir, teacher):
    root, data = workdir
    out = cli.main(_argv(root, data, "kd2", "--mode", "distillation", "--teacher_model",
                         teacher))
    model = out["trainer"].model
    saved = checkpoint.restore_params(teacher)
    live = model.teacher.state_dict()
    assert set(live) == set(saved)
    for name, value in saved.items():
        assert torch.equal(live[name].cpu(), value), name
    assert all(not p.requires_grad and p.grad is None for p in model.teacher.parameters())
    assert out["trainer"].state.step == 4  # the student trained: 14 clips in batches of 4

    path = Path(out["path"])
    assert path == root / "kd2" / "distilled_student_model"
    assert not (path / "meta.json").exists()  # weights only, as the JAX save_params
    student_sd = checkpoint.restore_params(str(path))
    assert set(student_sd) == set(model.student.state_dict())
    assert not any(k.startswith(("teacher.", "student.")) for k in student_sd)
    standard = MultimodalEmotionModel(out["trainer"].config)
    standard.load_state_dict(student_sd)  # strict
    for name, value in model.student.state_dict().items():
        assert torch.equal(standard.state_dict()[name], value.cpu()), name


def test_distillation_without_a_teacher_writes_nothing(tiny_media, workdir, capsys):
    root, data = workdir
    out = cli.main(_argv(root, data, "kd_none", "--mode", "distillation"))
    assert out == {"mode": "distillation"}
    assert "Error: Teacher model path required for distillation" in capsys.readouterr().out
    assert not (root / "kd_none").exists()


class _FakeTrainer:
    def __init__(self, model, config, **kw):
        self.config = config
        self.best_val_acc, self.best_val_f1 = 0.5, 0.25

    def train(self):
        return {}


def test_ablation_keys_and_epochs_match_jax(tiny_media, workdir, monkeypatch):
    root, data = workdir
    epochs_run = []
    train = ptrainer.AdvancedTrainer.train

    def counted(self):
        out = train(self)
        epochs_run.append((self.config.fusion_type, len(self.train_losses),
                           self.config.num_epochs))
        return out

    monkeypatch.setattr(ptrainer.AdvancedTrainer, "train", counted)
    out = cli.main(_argv(root, data, "abl", "--mode", "ablation"))
    results = out["results"]

    import simple_multimodal_tpu.models as jmodels
    import simple_multimodal_tpu.train.trainer as jtrainer

    monkeypatch.setattr(jmodels, "create_model", lambda cfg, model_type: None)
    monkeypatch.setattr(jtrainer, "AdvancedTrainer", _FakeTrainer)
    monkeypatch.setattr(jax_cli, "load_datasets", lambda *a, **k: dict.fromkeys(
        ("train", "val", "test")))
    jcfg = jax_cli.ModelConfig(data_path=data, save_path=str(root / "jabl"))
    jcfg.num_epochs = 1
    want = jax_cli.run_ablation_studies(jcfg, jconfig.DataConfig(),
                                        jconfig.ExperimentConfig(), 42)
    assert list(results) == list(want) == ["early", "late", "mult", "graph", "contrastive"]
    assert all(set(r) == {"val_accuracy", "val_f1"} for r in results.values())
    assert all(np.isfinite(v) for r in results.values() for v in r.values())
    assert epochs_run == [(f, 1, 1) for f in want]  # min(10, epochs) = 1 epoch each

    # past 10 epochs each fusion is cut to 10
    seen = []
    monkeypatch.setattr(cli, "load_datasets", lambda *a, **k: dict.fromkeys(
        ("train", "val", "test")))
    monkeypatch.setattr(pmodel, "create_model", lambda *a, **k: None)
    monkeypatch.setattr(ptrainer, "AdvancedTrainer",
                        lambda model, config, **kw: seen.append(config.num_epochs)
                        or _FakeTrainer(model, config))
    cfg = cli.ModelConfig(data_path=data, save_path=str(root / "abl12"))
    cfg.num_epochs = 12
    cli.run_ablation_studies(cfg, pconfig.DataConfig(), pconfig.ExperimentConfig(), "cpu")
    assert seen == [10] * 5 and cfg.num_epochs == 12


def test_all_runs_every_part_cleanly(tiny_media, workdir):
    root, data = workdir
    out = cli.main(_argv(root, data, "all", "--mode", "all", "--episodes", "1",
                         "--few_shot_samples", "1"))
    assert out["errors"] == {}
    assert list(out["results"]) == [*cli.ALL_STANDARD_FUSIONS, "few_shot", "robust",
                                    "ablation"]
    save = root / "all"
    for fusion in cli.ALL_STANDARD_FUSIONS:
        assert (save / f"final_model_{fusion}" / "checkpoint.pt").exists()
    assert (save / "robust_model" / "checkpoint.pt").exists()
    assert list(out["results"]["few_shot"]) == ["1_shot"]
    assert len(out["results"]["robust"]) == 7
    assert list(out["results"]["ablation"]) == ["early", "late", "mult", "graph", "contrastive"]
    cfg = json.loads((save / "final_config.json").read_text())
    assert cfg["model_config"]["fusion_type"] == "hierarchical"


def test_all_records_a_failure_and_runs_the_rest(tiny_media, workdir, monkeypatch, capsys):
    root, data = workdir
    calls = []

    def fake(name, value):
        def run(*a, **k):
            calls.append(name)
            return value
        return run

    def robust_fails(*a, **k):
        calls.append("robust")
        raise RuntimeError("robust boom")

    monkeypatch.setattr(cli, "train_standard_model",
                        lambda cfg, data_cfg, device, fusion, seed: calls.append(fusion)
                        or (f"final_model_{fusion}", None))
    monkeypatch.setattr(cli, "train_few_shot_model", fake("few_shot", {"1_shot": 1.0}))
    monkeypatch.setattr(cli, "train_robust_model", robust_fails)
    monkeypatch.setattr(cli, "run_ablation_studies", fake("ablation", {"early": {}}))
    out = cli.main(_argv(root, data, "all_fail", "--mode", "all"))
    assert out["errors"] == {"robust": "robust boom"}
    assert calls == [*cli.ALL_STANDARD_FUSIONS, "few_shot", "robust", "ablation"]
    assert "robust" not in out["results"] and out["results"]["ablation"] == {"early": {}}
    printed = capsys.readouterr().out
    assert "Error in robustness training: robust boom" in printed
    assert "Ablation results: {'early': {}}" in printed
    assert (root / "all_fail" / "final_config.json").exists()


# ----------------------------------------------------------------- profiling

def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        with profiling.annotate("smm_region"):
            x = torch.randn(64, 64)
            float((x @ x).sum())
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "smm_region" for e in events)
    assert any(e.key == "smm_region" for e in prof.key_averages())


def test_memory_stats_is_empty_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profiling.memory_stats() == {}
