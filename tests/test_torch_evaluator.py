"""The port's evaluator (``eval/evaluator.py``, ``eval/plots.py``) and
``evaluate_model_torch.py`` against the JAX package's ``ModelEvaluator`` on
the CPU: one tiny late-fusion model (per-modality metrics) whose JAX
checkpoint is written by orbax and whose port checkpoint comes from
``models/from_jax.py``, evaluated over the same sample set.
"""
import dataclasses
import importlib.util
import json
import re
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from simple_multimodal_tpu.config import config_to_dict
from simple_multimodal_tpu.data import dataset as jdataset
from simple_multimodal_tpu.data import sample_data as jsample
from simple_multimodal_tpu.eval.evaluator import ModelEvaluator as JaxEvaluator
from simple_multimodal_tpu.models import MultimodalEmotionModel
from simple_multimodal_tpu.train import checkpoint as jcheckpoint
from simple_multimodal_tpu.train.state import TrainState as JaxState
from simple_multimodal_tpu_torch import config as pconfig
from simple_multimodal_tpu_torch.data import dataset as pdataset
from simple_multimodal_tpu_torch.eval import evaluator as pevaluator
from simple_multimodal_tpu_torch.eval import metrics, plots
from simple_multimodal_tpu_torch.models.from_jax import state_dict_from_jax
from simple_multimodal_tpu_torch.models.multimodal_model import (
    MultimodalEmotionModel as PortModel)
from simple_multimodal_tpu_torch.train import checkpoint

ROOT = Path(__file__).resolve().parents[1]
B = 4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


eval_cli = _load("evaluate_model_torch", "evaluate_model_torch.py")


@pytest.fixture(scope="module", autouse=True)
def _no_hf_lookup():
    """No HF tokenizer lookup: both packages fall back to HashTokenizer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers", None)
        yield


@pytest.fixture(scope="module")
def setup(tiny_config, tmp_path_factory):
    """A sample set (one copy a package), the JAX checkpoint and the port's
    of the same tiny late-fusion weights, and both evaluators' results on
    the test split."""
    root = tmp_path_factory.mktemp("evaluator")
    # 6 clips an emotion: a test split of 7 (a wrap-padded batch of 4; t-SNE needs > 5)
    sample = jsample.create_sample_dataset(str(root / "sample"), 6, seed=42)
    jroot, proot = root / "jdata", root / "pdata"
    shutil.copytree(sample, jroot)
    shutil.copytree(sample, proot)

    cfg = dataclasses.replace(tiny_config, log_path=str(root / "logs"))
    cfg.fusion_type = "late"
    ds = jdataset.get_dataset("sample", str(jroot), "test", cfg)
    batch = jdataset.collate([ds[0]])
    model = MultimodalEmotionModel(cfg)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(3), batch["text"], batch["audio"], batch["video"]))
    jck = str(root / "jax_ck")
    jcheckpoint.save_checkpoint(jck, JaxState(step=0, params=params, opt_state=None,
                                              rng=jax.random.PRNGKey(0)),
                                epoch=0, config=cfg)

    pcfg = pconfig.config_from_dict(pconfig.ModelConfig, config_to_dict(cfg))
    port = PortModel(pcfg)
    port.load_state_dict(state_dict_from_jax(params, pcfg))
    pck = str(root / "port_ck")
    checkpoint.save_checkpoint(pck, port, config=pcfg)

    jev = JaxEvaluator(jck)
    jds = jdataset.get_dataset("sample", str(jroot), "test", jev.config)
    jres = jev.evaluate_dataset(jdataset.create_dataloader(jds, B, shuffle=False))
    pev = pevaluator.ModelEvaluator(pck, device="cpu")
    pds = pdataset.get_dataset("sample", str(proot), "test", pev.config)
    pres = pev.evaluate_dataset(pdataset.create_dataloader(pds, B, shuffle=False))
    return dict(root=root, proot=proot, jck=jck, pck=pck, pcfg=pcfg, jev=jev, pev=pev,
                jres=jres, pres=pres, n=len(pds))


def _close(got, want, path=""):
    """Nested dicts and lists of numbers equal within 1e-6."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert got == pytest.approx(want, abs=1e-6), path


def test_evaluate_dataset_matches_jax(setup):
    jres, pres = setup["jres"], setup["pres"]
    assert len(pres["targets"]) == setup["n"] > B  # a wrap-padded last batch, deduplicated
    np.testing.assert_array_equal(pres["targets"], jres["targets"])
    np.testing.assert_array_equal(pres["predictions"], jres["predictions"])
    np.testing.assert_allclose(pres["probabilities"], jres["probabilities"], atol=1e-4)
    np.testing.assert_allclose(pres["features"], jres["features"], atol=1e-4)
    _close(pres["metrics"], jres["metrics"])
    assert set(pres["individual_metrics"]) == {"text", "audio", "video"}
    _close(pres["individual_metrics"], jres["individual_metrics"])


def test_outputs_match_jax(setup, tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for ev, res, d in ((setup["jev"], setup["jres"], jdir), (setup["pev"], setup["pres"], pdir)):
        ev.create_visualizations(res, str(d))
        ev.generate_report(res, str(d))
        ev.save_detailed_results(res, str(d))
    pngs = sorted(p.name for p in pdir.glob("*.png"))
    assert pngs == sorted(p.name for p in jdir.glob("*.png"))
    assert len(pngs) == 7  # the seven families, the modality comparison included

    def headings(d):
        html = (d / "evaluation_report.html").read_text()
        return re.findall(r"<h[123]>(.*?)</h[123]>", html)

    assert headings(pdir) == headings(jdir)
    got = json.loads((pdir / "detailed_results.json").read_text())
    want = json.loads((jdir / "detailed_results.json").read_text())
    assert list(got) == list(want)
    assert got["predictions"] == want["predictions"] and got["targets"] == want["targets"]
    _close(got["metrics"], want["metrics"])


def test_numpy_confusion_matrix_and_roc_equal_scikit_learn():
    from sklearn.metrics import auc, confusion_matrix, roc_curve

    rng = np.random.default_rng(0)
    labels = [f"c{i}" for i in range(7)]
    for n in (5, 40, 300):
        targets = rng.integers(0, 7, n)
        preds = rng.integers(0, 7, n)
        probs = np.round(rng.dirichlet(np.ones(7), n), 2)  # rounded: tied scores
        np.testing.assert_array_equal(metrics.confusion_matrix(targets, preds, range(7)),
                                      confusion_matrix(targets, preds, labels=list(range(7))))
        curves = plots.roc_curves(targets, probs, labels)
        for i, name in enumerate(labels):
            binary = (targets == i).astype(int)
            if binary.sum() in (0, n):
                assert name not in curves
                continue
            fpr, tpr, _ = roc_curve(binary, probs[:, i])
            np.testing.assert_array_equal(curves[name][0], fpr)
            np.testing.assert_array_equal(curves[name][1], tpr)
            assert curves[name][2] == auc(fpr, tpr)


def test_plots_without_matplotlib_print_one_line_each(setup, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    setup["pev"].create_visualizations(setup["pres"], str(tmp_path))
    lines = [line for line in capsys.readouterr().out.splitlines() if "skipped" in line]
    assert lines == [f"{name} skipped: matplotlib is not installed" for name in (
        "confusion_matrix.png", "per_class_performance.png", "confidence_analysis.png",
        "roc_curves.png", "feature_tsne.png", "error_analysis.png", "modality_comparison.png")]
    assert not list(tmp_path.glob("*.png"))


def test_cli_writes_outputs_and_holds_the_f1_band(setup, tmp_path):
    argv = ["--model_path", setup["pck"], "--data_path", str(setup["proot"]), "--dataset",
            "sample", "--split", "test", "--batch_size", str(B), "--device", "cpu"]
    out = eval_cli.main(argv + ["--output_dir", str(tmp_path / "in"),
                                "--assert_f1_band", "0,1"])
    np.testing.assert_array_equal(out["predictions"], setup["pres"]["predictions"])
    for name in ("evaluation_report.html", "detailed_results.json"):
        assert (tmp_path / "in" / name).exists()
    f1 = out["metrics"]["f1_macro"]
    lo = f1 + 0.01 if f1 < 0.5 else 0.0
    hi = 1.0 if f1 < 0.5 else f1 - 0.01
    with pytest.raises(SystemExit) as exit_info:
        eval_cli.main(argv + ["--output_dir", str(tmp_path / "out"),
                              "--assert_f1_band", f"{lo},{hi}"])
    assert exit_info.value.code == 3


def test_cli_defaults_to_the_card(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for device in ([], ["--device", "auto"]):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            eval_cli.main(["--model_path", setup["pck"], "--output_dir", str(tmp_path),
                           *device])


@pytest.mark.parametrize("source", ["config_path", "meta", "payload", "default"])
def test_config_comes_from_the_first_source_present(setup, tmp_path, source):
    """``config_path``, then ``meta.json``, then the payload's config, then
    ``ModelConfig()``; a ``save_params`` directory (no config) loads with
    ``config_path``."""
    pcfg = dataclasses.replace(setup["pcfg"])
    ck = tmp_path / "ck"
    shutil.copytree(setup["pck"], ck)
    config_path = None
    if source == "config_path":
        pcfg.fusion_type = "early"  # differs from the checkpoint's own
        config_path = tmp_path / "cfg.json"
        config_path.write_text(json.dumps({"model_config": pconfig.config_to_dict(pcfg)}))
    if source in ("payload", "default"):
        (ck / "meta.json").unlink()
    if source == "default":
        checkpoint.save_params(str(ck), checkpoint.restore_params(str(ck)))
    got = pevaluator._config_for(str(ck), config_path and str(config_path))
    want = {"config_path": "early", "meta": "late", "payload": "late", "default": None}[source]
    assert getattr(got, "fusion_type", None) == want  # not a field: absent from the default
    if source == "default":
        assert got == pconfig.ModelConfig()
        late = tmp_path / "late.json"
        late.write_text(json.dumps(pconfig.config_to_dict(setup["pcfg"])))
        ev = pevaluator.ModelEvaluator(str(ck), str(late), device="cpu")
        assert ev.config.fusion_type == "late"


def test_missing_checkpoint_names_the_ones_there(setup, tmp_path):
    shutil.copytree(setup["pck"], tmp_path / "final_model_late")
    with pytest.raises(FileNotFoundError, match="Available checkpoints in .*: final_model_late"):
        pevaluator.ModelEvaluator(str(tmp_path / "best_model"), device="cpu")
