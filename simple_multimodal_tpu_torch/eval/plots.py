"""The evaluator's seven plot families (port of
simple_multimodal_tpu/eval/plots.py), with the same file names: confusion
matrices (counts and normalised), per-class bars, the confidence
distribution with a reliability diagram, per-class ROC curves, a t-SNE of
the features, the error analysis (with the top confused pairs) and the
per-modality comparison.

The confusion matrix and the ROC curves come from ``eval/metrics.py``
(numpy), not scikit-learn. Where matplotlib is missing, each function
prints one line and writes nothing; t-SNE needs scikit-learn too and is
skipped the same way where it is missing.
"""
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .metrics import auc, confusion_matrix, roc_curve


def _plt(what: str):
    """matplotlib's pyplot on the Agg backend, or None after one line
    naming the plot that is skipped."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"{what} skipped: matplotlib is not installed")
        return None
    return plt


def plot_confusion_matrix(targets, predictions, labels: List[str],
                          save_path: Path) -> None:
    plt = _plt("confusion_matrix.png")
    if plt is None:
        return
    ids = list(range(len(labels)))
    cm = confusion_matrix(targets, predictions, ids)
    with np.errstate(invalid="ignore", divide="ignore"):
        cm_norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)

    fig, axes = plt.subplots(1, 2, figsize=(16, 7))
    for ax, mat, title, fmt in (
        (axes[0], cm, "Confusion Matrix (Counts)", "d"),
        (axes[1], cm_norm, "Confusion Matrix (Normalized)", ".2f"),
    ):
        im = ax.imshow(mat, cmap="Blues")
        ax.set_xticks(ids, labels, rotation=45, ha="right")
        ax.set_yticks(ids, labels)
        for i in ids:
            for j in ids:
                v = mat[i, j]
                ax.text(j, i, format(v, fmt), ha="center", va="center",
                        color="white" if v > mat.max() / 2 else "black")
        ax.set_title(title)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(save_path / "confusion_matrix.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_per_class_performance(metrics: Dict, labels: List[str], save_path: Path) -> None:
    plt = _plt("per_class_performance.png")
    if plt is None:
        return
    x = np.arange(len(labels))
    w = 0.25
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.bar(x - w, metrics["per_class_f1"], w, label="F1")
    ax.bar(x, metrics["per_class_precision"], w, label="Precision")
    ax.bar(x + w, metrics["per_class_recall"], w, label="Recall")
    ax.set_xticks(x, labels, rotation=45, ha="right")
    ax.set_ylim(0, 1.05)
    ax.set_title("Per-Class Performance")
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path / "per_class_performance.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_confidence_distribution(probabilities, targets, predictions, save_path: Path) -> None:
    plt = _plt("confidence_analysis.png")
    if plt is None:
        return
    probabilities = np.asarray(probabilities)
    targets = np.asarray(targets)
    predictions = np.asarray(predictions)
    max_probs = probabilities.max(axis=1)
    correct = predictions == targets

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 6))
    bins = np.linspace(0, 1, 21)
    ax1.hist(max_probs[correct], bins=bins, alpha=0.6, label="Correct", color="green",
             density=True)
    ax1.hist(max_probs[~correct], bins=bins, alpha=0.6, label="Incorrect", color="red",
             density=True)
    ax1.set_title("Prediction Confidence Distribution")
    ax1.set_xlabel("Confidence")
    ax1.legend()
    ax1.grid(True, alpha=0.3)

    # reliability diagram: accuracy within confidence bins against confidence
    bin_ids = np.clip(np.digitize(max_probs, bins) - 1, 0, len(bins) - 2)
    accs, confs = [], []
    for b in range(len(bins) - 1):
        m = bin_ids == b
        if m.any():
            accs.append(correct[m].mean())
            confs.append(max_probs[m].mean())
    ax2.plot([0, 1], [0, 1], "k--", label="Perfect calibration")
    ax2.plot(confs, accs, "o-", label="Model")
    ax2.set_title("Reliability Diagram")
    ax2.set_xlabel("Mean Confidence")
    ax2.set_ylabel("Accuracy")
    ax2.legend()
    ax2.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path / "confidence_analysis.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def roc_curves(targets, probabilities, labels: List[str]) -> Dict[str, tuple]:
    """{label: (fpr, tpr, AUC)} one-vs-rest, for the classes that are
    neither absent from nor all of the targets."""
    targets = np.asarray(targets)
    probabilities = np.asarray(probabilities)
    out = {}
    for i, name in enumerate(labels):
        binary = (targets == i).astype(int)
        if binary.sum() in (0, len(binary)):
            continue
        fpr, tpr = roc_curve(binary, probabilities[:, i])
        out[name] = (fpr, tpr, auc(fpr, tpr))
    return out


def plot_roc_curves(targets, probabilities, labels: List[str], save_path: Path) -> None:
    plt = _plt("roc_curves.png")
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 8))
    for name, (fpr, tpr, area) in roc_curves(targets, probabilities, labels).items():
        ax.plot(fpr, tpr, label=f"{name} (AUC={area:.3f})")
    ax.plot([0, 1], [0, 1], "k--", alpha=0.5)
    ax.set_title("Per-Class ROC Curves (One-vs-Rest)")
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path / "roc_curves.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_feature_tsne(features, targets, labels: List[str], save_path: Path,
                      max_samples: int = 5000) -> None:
    plt = _plt("feature_tsne.png")
    if plt is None:
        return
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        print("feature_tsne.png skipped: scikit-learn is not installed")
        return
    features = np.asarray(features)
    targets = np.asarray(targets)
    if len(features) > max_samples:  # the reference subsamples to 5000
        idx = np.random.RandomState(42).choice(len(features), max_samples, replace=False)
        features, targets = features[idx], targets[idx]
    perplexity = min(30, max(2, len(features) - 1))
    emb = TSNE(n_components=2, random_state=42, perplexity=perplexity).fit_transform(features)
    fig, ax = plt.subplots(figsize=(10, 8))
    for i, name in enumerate(labels):
        m = targets == i
        if m.any():
            ax.scatter(emb[m, 0], emb[m, 1], label=name, alpha=0.6, s=18)
    ax.set_title("t-SNE of Fused Features")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path / "feature_tsne.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_error_analysis(targets, predictions, probabilities, labels: List[str],
                        save_path: Path) -> Optional[Dict]:
    plt = _plt("error_analysis.png")
    if plt is None:
        return None
    targets = np.asarray(targets)
    predictions = np.asarray(predictions)
    wrong = targets != predictions
    pairs: Dict[str, int] = {}
    for t, p in zip(targets[wrong], predictions[wrong]):
        key = f"{labels[t]}→{labels[p]}"
        pairs[key] = pairs.get(key, 0) + 1
    top = sorted(pairs.items(), key=lambda kv: -kv[1])[:10]

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(15, 6))
    per_class_err = [float(wrong[targets == i].mean()) if (targets == i).any() else 0.0
                     for i in range(len(labels))]
    ax1.bar(labels, per_class_err, color="salmon")
    ax1.set_title("Error Rate per True Class")
    ax1.set_xticks(range(len(labels)), labels, rotation=45, ha="right")
    ax1.grid(True, axis="y", alpha=0.3)
    if top:
        names, counts = zip(*top)
        ax2.barh(list(names)[::-1], list(counts)[::-1], color="indianred")
        ax2.set_title("Top Confused Pairs (true→predicted)")
    fig.tight_layout()
    fig.savefig(save_path / "error_analysis.png", dpi=150, bbox_inches="tight")
    plt.close(fig)
    return dict(top)


def plot_modality_comparison(individual_metrics: Dict, save_path: Path) -> None:
    plt = _plt("modality_comparison.png")
    if plt is None:
        return
    modalities = list(individual_metrics.keys())
    accs = [individual_metrics[m]["accuracy"] for m in modalities]
    f1s = [individual_metrics[m]["f1_macro"] for m in modalities]
    x = np.arange(len(modalities))
    fig, ax = plt.subplots(figsize=(9, 6))
    ax.bar(x - 0.2, accs, 0.4, label="Accuracy")
    ax.bar(x + 0.2, f1s, 0.4, label="F1 (Macro)")
    ax.set_xticks(x, [m.title() for m in modalities])
    ax.set_ylim(0, 1.05)
    ax.set_title("Per-Modality Performance (Late Fusion)")
    ax.legend()
    ax.grid(True, axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path / "modality_comparison.png", dpi=150, bbox_inches="tight")
    plt.close(fig)
