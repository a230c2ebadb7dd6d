"""The port's CLIs on the CPU: ``create_sample_data_torch.py`` followed by
``train_advanced_torch.py --device cpu --preset tiny`` in the standard,
few-shot and robust modes (in-process, at the tiny media sizes of
tests/conftest.py), what each writes, the dispatch of the other modes, the
refusal without a card, and the saved model served through
``MultimodalEmotionDemo`` from file paths, whose decode is held against the
JAX demo's on the same files.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from simple_multimodal_tpu.serving.demo import MultimodalEmotionDemo as JaxDemo
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.data.audio_io import load_audio_fixed
from simple_multimodal_tpu_torch.data.video_io import load_video_frames
from simple_multimodal_tpu_torch.models.multimodal_model import load_pretrained_model
from simple_multimodal_tpu_torch.serving.demo import MultimodalEmotionDemo

ROOT = Path(__file__).resolve().parents[1]
CLIP_FRAMES = 45  # the generator's clips: 3 s at 15 fps


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


train_cli = _load("train_advanced_torch")
data_cli = _load("create_sample_data_torch")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A sample set made by the port's CLI, and the tiny media sizes the
    trainer's ModelConfig takes in these tests."""
    root = tmp_path_factory.mktemp("cli")
    data = data_cli.main(["--output_dir", str(root / "data" / "sample"), "--num_samples", "3"])
    return root, data


@pytest.fixture
def tiny_media(monkeypatch, workdir):
    root, _ = workdir

    def tiny(**kw):
        kw.setdefault("log_path", str(root / "logs"))
        return pconfig.ModelConfig(text_max_length=16, audio_max_length=3200,
                                   video_max_frames=4, video_frame_size=(32, 32),
                                   fusion_hidden_size=32, fusion_num_heads=4,
                                   graph_hidden_size=16, adapter_size=8, prompt_length=4, **kw)

    monkeypatch.setattr(train_cli, "ModelConfig", tiny)
    monkeypatch.setitem(sys.modules, "transformers", None)  # no HF cache: skip the import
    return root


def _run(root, data, save, *extra):
    return train_cli.main(["--device", "cpu", "--preset", "tiny", "--data_path", data,
                           "--save_path", str(root / save), "--epochs", "1",
                           "--batch_size", "4", *extra])


def test_sample_data_cli_writes_the_set(workdir):
    _, data = workdir
    meta = json.loads((Path(data) / "generation_meta.json").read_text())
    assert meta["seed"] == 42 and "video_store" not in meta  # OpenCV here: mp4 clips
    assert len(list((Path(data) / "audio").glob("*.wav"))) == 21
    assert all(p.stat().st_size > 0 for p in (Path(data) / "video").glob("*.mp4"))


def test_standard_mode_trains_saves_resumes_and_serves(tiny_media, workdir):
    root, data = workdir
    out = _run(root, data, "std", "--fusion_type", "early", "--mesh", "1,1",
               "--flash_attention", "false", "--remat", "1")
    save = root / "std"
    final = save / "final_model_early"
    assert Path(out["path"]) == final
    for d in (final, save / "best_model"):
        meta = json.loads((d / "meta.json").read_text())
        assert set(meta) >= {"epoch", "metrics", "config"}
        assert (d / "checkpoint.pt").exists()
    assert "opt_state_fingerprint" in json.loads((final / "meta.json").read_text())
    cfg = json.loads((save / "final_config.json").read_text())
    assert set(cfg) == {"model_config", "data_config", "experiment_config"}
    assert cfg["model_config"]["fusion_type"] == "early"
    # the JAX package's TPU switches are recorded, not read
    assert cfg["model_config"]["flash_attention"] == "false"
    assert cfg["model_config"]["remat_encoders"] is True
    assert out["trainer"].state.step == 4  # 14 train clips in batches of 4

    resumed = _run(root, data, "std", "--fusion_type", "early", "--epochs", "2",
                   "--resume", str(final))["trainer"]
    assert resumed.start_epoch == 1 and resumed.state.step == 8

    model, config = load_pretrained_model(str(final), device="cpu")
    assert config.fusion_type == "early" and config.video_max_frames == 4
    demo = MultimodalEmotionDemo(checkpoint_path=str(final), device="cpu")
    # happy_000's disc pulses from frame to frame, so a wrong stride shows
    wav = Path(data) / "audio" / "happy_000.wav"
    clip = Path(data) / "video" / "happy_000.mp4"
    T, size = config.video_max_frames, tuple(config.video_frame_size)
    every_frame = load_video_frames(clip, CLIP_FRAMES, size)
    subsampled = every_frame[::CLIP_FRAMES // T][:T]
    assert not np.array_equal(subsampled, every_frame[:T])
    from_paths = demo.predict("I am so happy today!", str(wav), str(clip))
    arrays = demo.predict("I am so happy today!",
                          load_audio_fixed(wav, config.audio_sample_rate, config.audio_max_length),
                          subsampled)
    assert from_paths == arrays
    probs = np.array(list(from_paths["emotion_distribution"].values()))
    assert np.isfinite(probs).all() and abs(probs.sum() - 1.0) < 1e-5
    with torch.no_grad():
        direct = model(*demo.prepare("I am so happy today!", str(wav), str(clip)))
    np.testing.assert_array_equal(direct["emotion_probs"][0].numpy(),
                                  np.array(list(arrays["emotion_distribution"].values()),
                                           np.float32))


@pytest.mark.parametrize("name", ["happy_000", "surprise_000"])
def test_demo_decodes_files_as_the_jax_demo(name, workdir, tiny_config):
    """``prepare`` from a WAV path and a moving clip gives the audio and the
    stride-subsampled frames that the JAX demo's ``_process_audio`` and
    ``_process_video`` give on the same files."""
    _, data = workdir
    wav = str(Path(data) / "audio" / f"{name}.wav")
    clip = str(Path(data) / "video" / f"{name}.mp4")
    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, pconfig.config_to_dict(tiny_config))
    # decode only: the model is never called
    demo = MultimodalEmotionDemo(model=torch.nn.Identity(), config=pcfg, device="cpu")
    _, audio, video = demo.prepare("a request", wav, clip)
    jax_demo = SimpleNamespace(config=tiny_config)
    want_audio = JaxDemo._process_audio(jax_demo, wav)
    want_video = JaxDemo._process_video(jax_demo, clip)
    assert audio.dtype == torch.float32 and video.dtype == torch.uint8
    np.testing.assert_array_equal(audio.numpy(), want_audio)
    np.testing.assert_array_equal(video.numpy(), want_video)
    T = tiny_config.video_max_frames
    assert want_video.shape == (1, T, 32, 32, 3)
    first = load_video_frames(clip, T, tuple(tiny_config.video_frame_size))
    assert not np.array_equal(want_video[0], first)  # the stride is not 1 here


def test_few_shot_and_robust_modes_run(tiny_media, workdir):
    root, data = workdir
    out = _run(root, data, "fs", "--mode", "few_shot", "--episodes", "1",
               "--few_shot_samples", "1")
    assert list(out["results"]) == ["1_shot"] and np.isfinite(out["results"]["1_shot"])
    assert (root / "fs" / "final_config.json").exists()
    out = _run(root, data, "rb", "--mode", "robust")
    assert len(out["results"]) == 7 and "all" in out["results"]
    assert (root / "rb" / "robust_model" / "checkpoint.pt").exists()
    assert (root / "rb" / "final_config.json").exists()


@pytest.mark.parametrize("mode", ["distillation", "ablation", "all"])
def test_unported_modes_raise_with_a_pointer(mode, workdir, monkeypatch):
    """``--mode distillation``, ``ablation`` and ``all`` each reach their
    function (stubbed here; tests/test_torch_modes.py runs them) and write
    the run's config."""
    root, data = workdir
    called = []
    runs = {"distillation": ("train_knowledge_distillation", ("path", None)),
            "ablation": ("run_ablation_studies", {}),
            "all": ("run_all_experiments", ({}, {}))}
    for name, value in runs.values():
        monkeypatch.setattr(train_cli, name,
                            lambda *a, name=name, value=value, **k: called.append(name) or value)
    out = train_cli.main(["--device", "cpu", "--mode", mode, "--data_path", data,
                          "--save_path", str(root / mode), "--teacher_model", "teacher"])
    assert out["mode"] == mode and called == [runs[mode][0]]
    assert (root / mode / "final_config.json").exists()


@pytest.mark.parametrize("device", ["cuda", "auto"])
def test_the_card_is_the_default_and_raises_without_one(device, workdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, data = workdir
    argv = ["--data_path", data, "--save_path", str(tmp_path / "ck")]
    if device != "cuda":
        argv += ["--device", device]
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(argv)
    assert not (tmp_path / "ck").exists()


def test_cli_scripts_run_as_programs(tmp_path):
    """The two files as users run them: the generator writes a set; the
    trainer, given no --device, refuses to run without a card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(ROOT / "create_sample_data_torch.py"),
                          "--output_dir", str(tmp_path / "s"), "--num_samples", "1",
                          "--emotions", "happy", "sad", "angry"],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Video clips stored as: mp4" in out.stdout
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(ROOT / "train_advanced_torch.py"),
                          "--data_path", str(tmp_path / "s")],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and "--device cpu" in out.stderr
