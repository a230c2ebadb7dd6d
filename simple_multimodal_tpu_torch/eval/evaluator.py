"""Model evaluator: batch inference → metrics → plots → HTML report → JSON
(port of simple_multimodal_tpu/eval/evaluator.py).

``ModelEvaluator`` loads a port checkpoint directory on its device (the
card unless the caller passes ``device="cpu"``; it raises without one).
``evaluate_dataset`` returns the JAX evaluator's result schema (the metrics
dict, late fusion's per-modality metrics, the predictions, targets,
probabilities and features arrays, wrap-padded duplicates dropped);
``create_visualizations`` writes the seven plot families where matplotlib
is present; ``generate_report`` the HTML report; ``save_detailed_results``
``detailed_results.json``. Batches reach the device through the pipeline's
prefetcher; the outputs stay on the device until the loader is done and
are fetched once.
"""
import json
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig, config_from_dict, load_config_json
from ..data.pipeline import prefetch_to_device
from ..models.multimodal_model import load_pretrained_model
from ..ops.attention import require_device
from ..train.checkpoint import load_payload, read_meta
from ..train.steps import device_batch, make_eval_step
from ..train.trainer import dedupe_by_sample_id
from . import plots
from .metrics import accuracy_f1, calculate_metrics


def _config_for(model_path: str, config_path: Optional[str]) -> ModelConfig:
    """The model's config: ``config_path`` (a JSON file, with or without a
    ``model_config`` key), else the checkpoint's ``meta.json``, else the
    config in its payload, else ``ModelConfig()``."""
    if config_path:
        data = load_config_json(config_path)
        return config_from_dict(ModelConfig, data.get("model_config", data))
    meta_cfg = read_meta(model_path).get("config")
    if meta_cfg:
        return config_from_dict(ModelConfig, meta_cfg)
    payload_cfg = load_payload(model_path).get("config")
    if payload_cfg:
        return config_from_dict(ModelConfig, json.loads(payload_cfg))
    return ModelConfig()


class ModelEvaluator:
    """Loads a checkpoint (and an optional config JSON) and evaluates data sets."""

    def __init__(self, model_path: str, config_path: Optional[str] = None,
                 config: Optional[ModelConfig] = None, device="cuda"):
        self.device = require_device(device, "ModelEvaluator")
        if not Path(model_path).exists():
            hint = ""
            parent = Path(model_path).parent
            if parent.is_dir():
                finals = sorted(p.name for p in parent.iterdir()
                                if p.name.startswith(("final_model", "checkpoint_")))
                if finals:
                    hint = f" Available checkpoints in {parent}: {', '.join(finals)}."
            raise FileNotFoundError(
                f"No checkpoint at {model_path}.{hint} (A run whose val F1 "
                "never improves writes best_model only once per run — "
                "re-run training or point --model_path at a final_model_* "
                "directory.)")
        if config is None:
            config = _config_for(model_path, config_path)
        self.model, self.config = load_pretrained_model(model_path, config, self.device)
        self.eval_step = make_eval_step(self.model)
        n = sum(p.numel() for p in self.model.parameters())
        print(f"Model loaded: {n:,} parameters "
              f"(fusion={getattr(config, 'fusion_type', 'hierarchical')})")

    def evaluate_dataset(self, data_loader) -> Dict:
        preds, targets, probs, feats, ids = [], [], [], [], []
        individual = {"text": [], "audio": [], "video": []}

        print("Running evaluation...")
        for batch in prefetch_to_device(data_loader, size=2, device=self.device):
            out = self.eval_step(device_batch(batch))
            preds.append(out["predictions"])
            targets.append(batch["emotion"])
            probs.append(out["probs"].float())
            feats.append(out["features"].float())
            ids.extend(batch["sample_ids"])
            for modality, logits in out.get("individual_logits", {}).items():
                individual[modality].append(logits.argmax(dim=-1))

        def fetch(tensors):
            return torch.cat(tensors).cpu().numpy()

        n = self.config.num_emotions
        predictions, targets, probabilities, features = (
            (fetch(preds), fetch(targets), fetch(probs), fetch(feats)) if ids else
            (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, n), np.float32), None))
        # drop wrap-padded duplicates: each item of the data set counts once
        if ids:
            predictions, targets, probabilities, features = dedupe_by_sample_id(
                ids, predictions, targets, probabilities, features)
        individual_metrics = {}
        for modality, parts in individual.items():
            if parts:
                (modality_preds,) = dedupe_by_sample_id(ids, fetch(parts))
                individual_metrics[modality] = accuracy_f1(targets, modality_preds)

        metrics = calculate_metrics(targets, predictions, probabilities,
                                    self.config.emotion_labels)
        return {
            "metrics": metrics,
            "individual_metrics": individual_metrics,
            "predictions": predictions,
            "targets": targets,
            "probabilities": probabilities,
            "features": features,
        }

    # ------------------------------------------------------------------ plots
    def create_visualizations(self, results: Dict, save_dir: str) -> None:
        save_path = Path(save_dir)
        save_path.mkdir(parents=True, exist_ok=True)
        labels = self.config.emotion_labels
        t, p, pr = results["targets"], results["predictions"], results["probabilities"]
        plots.plot_confusion_matrix(t, p, labels, save_path)
        plots.plot_per_class_performance(results["metrics"], labels, save_path)
        plots.plot_confidence_distribution(pr, t, p, save_path)
        plots.plot_roc_curves(t, pr, labels, save_path)
        if results["features"] is not None and len(results["features"]) > 5:
            try:
                plots.plot_feature_tsne(results["features"], t, labels, save_path)
            except Exception as e:  # t-SNE can fail on degenerate inputs
                print(f"t-SNE skipped: {e}")
        plots.plot_error_analysis(t, p, pr, labels, save_path)
        if results["individual_metrics"]:
            plots.plot_modality_comparison(results["individual_metrics"], save_path)
        print(f"Visualizations saved to: {save_path}")

    # ----------------------------------------------------------------- report
    def generate_report(self, results: Dict, save_dir: str) -> str:
        report_path = Path(save_dir) / "evaluation_report.html"
        m = results["metrics"]
        labels = self.config.emotion_labels

        def grade(v):
            return ("good", "Excellent") if v > 0.8 else (
                ("warning", "Good") if v > 0.6 else ("poor", "Needs Improvement"))

        acc_cls, acc_word = grade(m["accuracy"])
        rows = "\n".join(
            f"<tr><td>{labels[i]}</td>"
            f"<td>{m['per_class_f1'][i]:.4f}</td>"
            f"<td>{m['per_class_precision'][i]:.4f}</td>"
            f"<td>{m['per_class_recall'][i]:.4f}</td></tr>"
            for i in range(len(labels))
        )
        modality_rows = "\n".join(
            f"<tr><td>{mod.title()}</td><td>{im['accuracy']:.4f}</td>"
            f"<td>{im['f1_macro']:.4f}</td></tr>"
            for mod, im in results["individual_metrics"].items()
        )
        modality_section = (
            f"""<div class="section"><h2>🧩 Per-Modality Performance</h2>
            <table class="table"><tr><th>Modality</th><th>Accuracy</th>
            <th>F1 (Macro)</th></tr>{modality_rows}</table></div>"""
            if results["individual_metrics"] else ""
        )
        roc_div = (
            f'<div class="metric"><strong>ROC AUC:</strong> {m["roc_auc"]:.4f}</div>'
            if m["roc_auc"] else ""
        )
        cs = m["confidence_stats"]
        images = "\n".join(
            f'<div class="section"><h3>{name}</h3><img src="{fn}" width="90%"/></div>'
            for name, fn in [
                ("Confusion Matrices", "confusion_matrix.png"),
                ("Per-Class Performance", "per_class_performance.png"),
                ("Confidence Analysis", "confidence_analysis.png"),
                ("ROC Curves", "roc_curves.png"),
                ("Feature t-SNE", "feature_tsne.png"),
                ("Error Analysis", "error_analysis.png"),
                ("Modality Comparison", "modality_comparison.png"),
            ]
            if (Path(save_dir) / fn).exists()
        )
        device = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                  else "CPU")
        html = f"""<!DOCTYPE html>
<html>
<head>
  <title>Multimodal Emotion Recognition - Evaluation Report</title>
  <style>
    body {{ font-family: Arial, sans-serif; margin: 40px; }}
    .header {{ background-color: #f0f0f0; padding: 20px; border-radius: 5px; }}
    .section {{ margin: 20px 0; }}
    .metric {{ background-color: #e8f4fd; padding: 10px; margin: 5px 0;
               border-radius: 3px; }}
    .table {{ border-collapse: collapse; width: 100%; }}
    .table th, .table td {{ border: 1px solid #ddd; padding: 8px;
                            text-align: left; }}
    .table th {{ background-color: #f2f2f2; }}
    .good {{ color: green; font-weight: bold; }}
    .warning {{ color: orange; font-weight: bold; }}
    .poor {{ color: red; font-weight: bold; }}
  </style>
</head>
<body>
  <div class="header">
    <h1>🎭 Multimodal Emotion Recognition Evaluation Report</h1>
    <p>Generated on: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}</p>
    <p>Backend: PyTorch port ({device}) · fusion =
       {getattr(self.config, 'fusion_type', 'hierarchical')}</p>
  </div>
  <div class="section">
    <h2>📊 Overall Performance</h2>
    <div class="metric"><strong>Accuracy:</strong> {m['accuracy']:.4f}
      <span class="{acc_cls}">({acc_word})</span></div>
    <div class="metric"><strong>F1-Score (Macro):</strong> {m['f1_macro']:.4f}</div>
    <div class="metric"><strong>F1-Score (Weighted):</strong> {m['f1_weighted']:.4f}</div>
    <div class="metric"><strong>Precision (Macro):</strong> {m['precision_macro']:.4f}</div>
    <div class="metric"><strong>Recall (Macro):</strong> {m['recall_macro']:.4f}</div>
    {roc_div}
  </div>
  <div class="section">
    <h2>🎯 Per-Class Performance</h2>
    <table class="table">
      <tr><th>Emotion</th><th>F1-Score</th><th>Precision</th><th>Recall</th></tr>
      {rows}
    </table>
  </div>
  <div class="section">
    <h2>🔍 Confidence Analysis</h2>
    <div class="metric"><strong>Mean Confidence:</strong>
      {cs['mean_confidence']:.4f} ± {cs['confidence_std']:.4f}</div>
    <div class="metric"><strong>Mean Confidence (Correct):</strong>
      {cs['mean_confidence_correct']:.4f}</div>
    <div class="metric"><strong>Mean Confidence (Incorrect):</strong>
      {cs['mean_confidence_incorrect']:.4f}</div>
  </div>
  {modality_section}
  {images}
</body>
</html>"""
        with open(report_path, "w") as f:
            f.write(html)
        print(f"Report saved to: {report_path}")
        return str(report_path)

    def save_detailed_results(self, results: Dict, save_dir: str) -> str:
        results_path = Path(save_dir) / "detailed_results.json"
        json_results = {
            "metrics": results["metrics"],
            "individual_metrics": results["individual_metrics"],
            "predictions": results["predictions"].tolist(),
            "targets": results["targets"].tolist(),
            "probabilities": results["probabilities"].tolist(),
        }
        with open(results_path, "w") as f:
            json.dump(json_results, f, indent=2)
        return str(results_path)
