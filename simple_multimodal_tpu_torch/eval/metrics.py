"""Evaluation metrics in numpy (port of simple_multimodal_tpu/eval/metrics.py).

The JAX package computes these with scikit-learn, which the card's machine
does not have. ``calculate_metrics`` gives the same dict, keys and values
(scikit-learn's definitions, ``labels=range(K)`` and ``zero_division=0``):
accuracy; F1, precision and recall, macro/weighted/micro and per class;
one-vs-rest macro ROC-AUC with tied scores ranked by their midrank (None
where it is undefined: a class absent from the targets, rows of scores
that do not sum to 1, no rows); ``classification_report`` as its
``output_dict``; and the confidence statistics. The evaluator's plots take
``confusion_matrix``, ``roc_curve`` and ``auc`` from here.
"""
from typing import Dict, List, Optional, Sequence

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den in f64, 0 where den is 0 (``zero_division=0``)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64).copy()
    mask = den == 0
    den[mask] = 1
    out = num / den
    out[mask] = 0.0
    return out


def _counts(targets, predictions, labels):
    t = np.asarray(targets)
    p = np.asarray(predictions)
    labels = np.asarray(labels)
    tp = np.array([np.sum((t == c) & (p == c)) for c in labels], np.int64)
    pred = np.array([np.sum(p == c) for c in labels], np.int64)
    true = np.array([np.sum(t == c) for c in labels], np.int64)
    return tp, pred, true


def precision_recall_f1(targets, predictions, labels: Sequence[int],
                        average: Optional[str] = None):
    """scikit-learn's ``precision_recall_fscore_support`` (β = 1,
    ``zero_division=0``): per-class arrays and the support for
    ``average=None``, else three floats."""
    tp, pred, true = _counts(targets, predictions, labels)
    support = true
    if average == "micro":
        tp, pred, true = tp.sum(keepdims=True), pred.sum(keepdims=True), true.sum(keepdims=True)
    precision = _divide(tp, pred)
    recall = _divide(tp, true)
    f1 = _divide(2.0 * tp.astype(np.float64), true.astype(np.float64) + pred)
    if average is None:
        return precision, recall, f1, support
    weights = true if average == "weighted" else None

    def avg(a):
        if a.shape[0] == 0:
            return float("nan")
        if weights is None or not np.any(weights):
            return float(np.mean(a))
        return float(np.average(a, weights=weights))

    return avg(precision), avg(recall), avg(f1)


def _roc_points(y: np.ndarray, score: np.ndarray):
    """(false, true) positive counts at each distinct score, highest first
    (scikit-learn's ``_binary_clf_curve``)."""
    order = np.argsort(score, kind="mergesort")[::-1]
    s, yy = score[order], y[order].astype(np.float64)
    distinct = np.where(np.diff(s))[0]
    ends = np.r_[distinct, yy.size - 1]
    tps = np.cumsum(yy)[ends]
    fps = 1 + ends - tps
    return fps, tps


def roc_curve(y, score, drop_intermediate: bool = True):
    """(fpr, tpr) of binary targets ``y`` against ``score``, as
    scikit-learn's ``roc_curve``: the curve starts at (0, 0) and, with
    ``drop_intermediate``, keeps only the points where it bends."""
    fps, tps = _roc_points(np.asarray(y), np.asarray(score))
    if drop_intermediate and len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fps, tps = np.r_[0, fps], np.r_[0, tps]
    return fps / fps[-1], tps / tps[-1]


def auc(x, y) -> float:
    """Area under a curve by the trapezoid rule (scikit-learn's ``auc``
    for an increasing ``x``)."""
    return float(_trapezoid(y, x))


def _binary_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve of binary targets ``y`` by the trapezoid
    rule over the curve's distinct thresholds (scikit-learn's
    ``roc_curve`` + ``auc``): tied scores count half, their midrank."""
    fpr, tpr = roc_curve(y, score, drop_intermediate=False)
    return auc(fpr, tpr)


def confusion_matrix(targets, predictions, labels: Sequence[int]) -> np.ndarray:
    """Counts [true, predicted] over ``labels`` (scikit-learn's
    ``confusion_matrix(..., labels=labels)``): pairs with a label outside
    ``labels`` are left out."""
    index = {int(c): i for i, c in enumerate(labels)}
    cm = np.zeros((len(index), len(index)), np.int64)
    for t, p in zip(np.asarray(targets).tolist(), np.asarray(predictions).tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def accuracy_f1(targets, predictions) -> Dict[str, float]:
    """Accuracy and F1 macro/weighted over the labels present in either
    array (scikit-learn's default labels, as the JAX trainer and evaluator
    call ``f1_score``)."""
    t, p = np.asarray(targets), np.asarray(predictions)
    labels = np.unique(np.r_[t, p])
    return {
        "accuracy": float((t == p).mean()) if len(t) else 0.0,
        "f1_macro": precision_recall_f1(t, p, labels, "macro")[2],
        "f1_weighted": precision_recall_f1(t, p, labels, "weighted")[2],
    }


def roc_auc_ovr_macro(targets, probabilities, labels: Sequence[int]) -> Optional[float]:
    """One-vs-rest macro ROC-AUC (scikit-learn's ``roc_auc_score(...,
    multi_class="ovr", average="macro", labels=labels)``), None where that
    raises or is not finite."""
    t = np.asarray(targets)
    probs = np.asarray(probabilities, np.float64)
    labels = np.asarray(labels)
    if t.size == 0 or probs.ndim != 2 or probs.shape[1] != labels.size:
        return None
    if not np.allclose(1, probs.sum(axis=1)) or np.setdiff1d(t, labels).size:
        return None
    scores = []
    for j, c in enumerate(labels):
        y = t == c
        if y.all() or not y.any():
            return None  # one class only in this column: undefined, nan in scikit-learn
        scores.append(_binary_auc(y, probs[:, j]))
    out = float(np.mean(scores))
    return out if np.isfinite(out) else None


def classification_report(targets, predictions, labels: Sequence[int],
                          target_names: List[str]) -> Dict:
    """scikit-learn's ``classification_report(..., output_dict=True,
    zero_division=0)`` with the given labels."""
    headers = ("precision", "recall", "f1-score", "support")
    p, r, f, s = precision_recall_f1(targets, predictions, labels)
    report = {name: dict(zip(headers, (float(a), float(b), float(c), float(d))))
              for name, a, b, c, d in zip(target_names, p, r, f, s)}
    present = set(np.unique(np.r_[np.asarray(targets), np.asarray(predictions)]).tolist())
    micro_is_accuracy = set(np.asarray(labels).tolist()) >= present
    for average in ("micro", "macro", "weighted"):
        heading = "accuracy" if average == "micro" and micro_is_accuracy else f"{average} avg"
        ap, ar, af = precision_recall_f1(targets, predictions, labels, average)
        report[heading] = dict(zip(headers, (float(ap), float(ar), float(af), float(np.sum(s)))))
    if "accuracy" in report:
        report["accuracy"] = report["accuracy"]["precision"]
    return report


def calculate_metrics(targets: np.ndarray, predictions: np.ndarray,
                      probabilities: np.ndarray,
                      emotion_labels: List[str]) -> Dict:
    targets = np.asarray(targets)
    predictions = np.asarray(predictions)
    probabilities = np.asarray(probabilities)
    labels = list(range(len(emotion_labels)))
    accuracy = float((targets == predictions).mean()) if len(targets) else 0.0

    max_probs = probabilities.max(axis=1) if len(probabilities) else np.zeros(0)
    correct = predictions == targets
    confidence_stats = {
        "mean_confidence": float(max_probs.mean()) if len(max_probs) else 0.0,
        "mean_confidence_correct": (
            float(max_probs[correct].mean()) if correct.any() else 0.0
        ),
        "mean_confidence_incorrect": (
            float(max_probs[~correct].mean()) if (~correct).any() else 0
        ),
        "confidence_std": float(max_probs.std()) if len(max_probs) else 0.0,
    }
    per_p, per_r, per_f, _ = precision_recall_f1(targets, predictions, labels)
    macro = precision_recall_f1(targets, predictions, labels, "macro")
    weighted = precision_recall_f1(targets, predictions, labels, "weighted")
    micro = precision_recall_f1(targets, predictions, labels, "micro")
    return {
        "accuracy": accuracy,
        "f1_macro": macro[2],
        "f1_weighted": weighted[2],
        "f1_micro": micro[2],
        "precision_macro": macro[0],
        "precision_weighted": weighted[0],
        "recall_macro": macro[1],
        "recall_weighted": weighted[1],
        "roc_auc": roc_auc_ovr_macro(targets, probabilities, labels),
        "per_class_f1": per_f.tolist(),
        "per_class_precision": per_p.tolist(),
        "per_class_recall": per_r.tolist(),
        "classification_report": classification_report(targets, predictions, labels,
                                                       emotion_labels),
        "confidence_stats": confidence_stats,
    }
