"""Trainers: standard, few-shot, robustness (port of
simple_multimodal_tpu/train/trainer.py).

``AdvancedTrainer``: the epoch loop over the port's train step, OneCycle
over the loader's steps, the epoch's losses summed on the device and
fetched once, validation with the metrics of ``eval/metrics.py`` over the
clips without their wrap-padded duplicates, the best model (on validation
F1-macro) snapshotted on the device and written once after training (or at
every improvement with ``eager_best_checkpoint``; written at least once
even if F1 never rises above 0), early stopping with patience, a
checkpoint every 10 epochs, the test set, the learning-rate history and
``resume_from`` (parameters, moments, count, step and generator).
``FewShotTrainer``: episodes over the adapters, the prompt and the
prototype network only, the support batch sorted by label.
``RobustnessTrainer``: the train step with each modality zeroed with
probability 0.3 on ``robust_prediction``, and the seven-scenario
evaluation.

Batches reach the device through ``data/pipeline.py``: a data set that
fits ``device_data_cache_mb`` stays on the card (``DeviceCachedLoader``),
else a producer thread prefetches. The plots need matplotlib; without it
the trainer prints one line and writes no PNG.

Data parallelism (JAX ``trainer.py:88-105, 128-137, 177-185, 254-256``):
``AdvancedTrainer`` makes the mesh of ``config.mesh_shape`` (one process a
data shard, ``parallel/mesh.py``), broadcasts rank 0's parameters, feeds
each rank its rows of every global batch (``DistributedLoader``, or the
device cache's row gather) and steps with the gradients averaged over the
ranks. Validation and test predictions are gathered from every rank before
the metrics, and the validation loss is averaged over the ranks, so every
rank takes the same best-model and early-stopping decisions. Rank 0 alone
prints the epochs and writes checkpoints, ``best_model/`` and plots, the
others waiting at a barrier after each write. ``RobustnessTrainer`` and the
distillation trainer inherit this; ``FewShotTrainer`` ignores the mesh, as
the JAX one does.

Tensor parallelism (JAX ``trainer.py:98-105, 128-137, 177-185``): with a
``model`` axis m > 1 the d·m processes keep their shards of the parameters
the JAX rule shards (``parallel/tensor.py::shard_module``) after the
broadcast, and the optimizer's moments are shards too. The m processes of a
data index take the same rows; validation gathers over the data group.
Every write gathers the whole state on every process first
(``write_checkpoint``), then rank 0 writes it; a resume cuts the whole
state to this process's shards, so checkpoints resume across meshes.
``num_params`` counts the whole model.
"""
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.pipeline import (DeviceCachedLoader, DistributedLoader, estimate_batch_bytes,
                             prefetch_to_device, to_device)
from ..eval.metrics import accuracy_f1, classification_report, confusion_matrix
from ..parallel.mesh import make_mesh, replicated
from ..parallel.tensor import gather_state_dict, shard_module
from .checkpoint import optimizer_state, restore_checkpoint, save_checkpoint
from .optim import (TRAINABLE_MARKERS, freeze, is_trainable_name, make_optimizer,
                    make_trainable_only_optimizer)
from .state import TrainState
from .steps import device_batch, make_eval_step, make_fewshot_step, make_train_step

_warned_no_plots = False


def dedupe_by_sample_id(ids, *arrays):
    """Drop wrap-padded duplicates: keep the first occurrence of each id."""
    ids = np.asarray(ids)
    _, first = np.unique(ids, return_index=True)
    keep = np.sort(first)
    return tuple(np.asarray(a)[keep] for a in arrays)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (said once)."""
    global _warned_no_plots
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        if not _warned_no_plots:
            _warned_no_plots = True
            print("matplotlib is not installed: no confusion-matrix or training-curve PNGs",
                  flush=True)
        return None
    return plt


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class AdvancedTrainer:
    """Standard trainer."""

    def __init__(self, model, config, train_loader, val_loader,
                 test_loader=None, model_type: str = "standard", seed: int = 0,
                 resume_from: Optional[str] = None):
        self.model = model
        self.config = config
        self.device = _model_device(model)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.model_type = model_type
        self.num_params = sum(p.numel() for p in model.parameters())
        self.mesh = make_mesh(getattr(config, "mesh_shape", (1, 1)), self.device)
        replicated(model, self.mesh)
        shard_module(model, self.mesh)

        # the loaders yield global batches: OneCycle counts global steps
        total_steps = max(len(train_loader) * config.num_epochs, 2)
        self.optimizer = make_optimizer(config, model, total_steps)
        self.state = TrainState.create(seed)
        self.start_epoch = 0
        if resume_from:
            payload = restore_checkpoint(resume_from, model, self.optimizer, self.state,
                                         mesh=self.mesh)
            epoch = payload["meta"].get("epoch")
            if epoch is not None:
                self.start_epoch = int(epoch) + 1
            self._log(f"Resumed from {resume_from} at step {self.state.step} "
                      f"(epoch {self.start_epoch})")

        augment = getattr(train_loader.dataset, "augment", False)
        self.train_step = make_train_step(model, self.optimizer, config, augment=augment,
                                          compute_contrastive_loss=True, mesh=self.mesh)
        self.eval_step = make_eval_step(model)

        self.current_epoch = 0
        self.best_val_acc = 0.0
        self.best_val_f1 = 0.0
        self.train_losses: List[float] = []
        self.val_losses: List[float] = []
        self.val_accuracies: List[float] = []
        self.val_f1_scores: List[float] = []
        self.lr_history: List[float] = []
        self.epoch_times: List[float] = []

        # a data set that fits the budget stays on the card across epochs
        budget = getattr(config, "device_data_cache_mb", 0) * 1_000_000
        self.device_cached = False
        if budget > 0 and self.device.type == "cuda":
            per_batch = estimate_batch_bytes(next(iter(train_loader)))
            total = per_batch * (len(train_loader) + len(val_loader)
                                 + (len(test_loader) if test_loader else 0))
            if total <= budget:
                self._log(f"Device-caching dataset ({total / 1e6:.0f} MB)")
                self.train_loader, self.val_loader, self.test_loader = (
                    DeviceCachedLoader(loader, self.device, seed=seed, mesh=self.mesh)
                    if loader else loader for loader in (train_loader, val_loader, test_loader))
                self.device_cached = True
        if self.mesh.size > 1 and not self.device_cached:
            self.train_loader, self.val_loader, self.test_loader = (
                DistributedLoader(loader, self.mesh) if loader else loader
                for loader in (train_loader, val_loader, test_loader))

        self.patience = getattr(config, "patience", 10)
        self.patience_counter = 0
        # best-model checkpoints: snapshot on the device, write once after
        # training (eager_best_checkpoint writes at every improvement)
        self.eager_best_checkpoint = bool(getattr(config, "eager_best_checkpoint", False))
        self._best_snapshot = None
        self._best_written = False

    def _log(self, *args) -> None:
        if self.mesh.rank == 0:
            print(*args)

    # ------------------------------------------------------------------ train
    def _iter(self, loader):
        if isinstance(loader, DeviceCachedLoader):
            return iter(loader)
        return prefetch_to_device(loader, size=2, device=self.device)

    def train_epoch(self) -> Dict[str, float]:
        # the loss parts are summed on the device and fetched once: the
        # reported metrics are epoch means, with no host sync per batch
        sums = None
        n = 0
        self.train_loader.set_epoch(self.current_epoch)
        for batch in self._iter(self.train_loader):
            self.state, parts = self.train_step(self.state, device_batch(batch))
            sums = parts if sums is None else {k: sums[k] + v for k, v in parts.items()}
            n += 1
        if not n:
            return {"total_loss": 0.0}
        keys = list(sums)
        vals = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
        return {k: v / n for k, v in zip(keys, vals)}

    def _predict(self, loader, step, with_loss: bool = False):
        """(predictions, targets, probs, sample ids, mean loss) over a loader,
        the device results fetched once; under a mesh every rank's rows,
        gathered in the global batches' order, and the loss averaged over the
        ranks."""
        gather = self.mesh.gather
        preds, targets, probs, ids = [], [], [], []
        loss, batches = None, 0
        for batch in self._iter(loader):
            out = step(device_batch(batch))
            preds.append(gather(out["predictions"]))
            targets.append(gather(batch["emotion"]))
            probs.append(gather(out["probs"].float()))
            ids.extend(batch["sample_ids"])
            if with_loss:
                loss = out["loss"] if loss is None else loss + out["loss"]
            batches += 1
        if not batches:
            return [], [], np.zeros((0, self.config.num_emotions)), [], 0.0
        preds = torch.cat(preds).cpu().numpy()
        targets = torch.cat(targets).cpu().numpy()
        probs = torch.cat(probs).cpu().numpy()
        mean_loss = 0.0
        if with_loss:
            loss = loss.float().reshape(1)
            self.mesh.all_reduce_mean_([loss])
            mean_loss = float(loss) / batches
        return preds, targets, probs, ids, mean_loss

    def validate(self):
        preds, targets, probs, ids, val_loss = self._predict(self.val_loader, self.eval_step,
                                                             with_loss=True)
        preds, targets, probs = dedupe_by_sample_id(ids, preds, targets, probs)
        preds, targets = preds.tolist(), targets.tolist()
        m = accuracy_f1(targets, preds)
        metrics = {
            "val_loss": val_loss,
            "val_accuracy": m["accuracy"],
            "val_f1_macro": m["f1_macro"],
            "val_f1_weighted": m["f1_weighted"],
        }
        class_report = classification_report(targets, preds,
                                             list(range(self.config.num_emotions)),
                                             self.config.emotion_labels)
        return metrics, class_report, preds, targets, probs

    def current_lr(self) -> float:
        return float(self.optimizer.schedule(self.optimizer.count))

    def train(self) -> Dict[str, List[float]]:
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "cpu")
        self._log(f"Starting training on {self.device} ({name}, mesh {self.mesh.shape})")
        self._log(f"Model parameters: {self.num_params:,}")

        for epoch in range(self.start_epoch, self.config.num_epochs):
            self.current_epoch = epoch
            t0 = time.time()
            train_metrics = self.train_epoch()
            val_metrics, class_report, predictions, targets, probs = self.validate()
            self.epoch_times.append(time.time() - t0)

            self.train_losses.append(train_metrics.get("total_loss", 0.0))
            self.val_losses.append(val_metrics["val_loss"])
            self.val_accuracies.append(val_metrics["val_accuracy"])
            self.val_f1_scores.append(val_metrics["val_f1_macro"])
            self.lr_history.append(self.current_lr())

            self._log(f"\nEpoch {epoch + 1}/{self.config.num_epochs} "
                      f"({self.epoch_times[-1]:.1f}s)")
            self._log(f"Train Loss: {self.train_losses[-1]:.4f}")
            self._log(f"Val Loss: {val_metrics['val_loss']:.4f}")
            self._log(f"Val Accuracy: {val_metrics['val_accuracy']:.4f}")
            self._log(f"Val F1 (Macro): {val_metrics['val_f1_macro']:.4f}")

            improved = val_metrics["val_f1_macro"] > self.best_val_f1
            # the best model is written at least once even when val F1
            # never beats 0.0, so that best_model/ always exists after a
            # run; patience and plots keep the strict-improvement rule
            if improved or (self._best_snapshot is None and not self._best_written):
                if improved:
                    self.best_val_f1 = val_metrics["val_f1_macro"]
                    self.best_val_acc = val_metrics["val_accuracy"]
                if self.eager_best_checkpoint:
                    self.save_checkpoint("best_model", epoch, val_metrics)
                    self._best_written = True
                else:
                    self._best_snapshot = (
                        epoch, dict(val_metrics),
                        {k: v.detach().clone() for k, v in self.model.state_dict().items()},
                    )
            if improved:
                self.patience_counter = 0
                self.plot_confusion_matrix(targets, predictions, epoch)
            else:
                self.patience_counter += 1

            if self.patience_counter >= self.patience:
                self._log(f"Early stopping at epoch {epoch + 1}")
                break

            if (epoch + 1) % 10 == 0:
                self.save_checkpoint(f"checkpoint_epoch_{epoch + 1}", epoch, val_metrics)

        if self._best_snapshot is not None:
            best_epoch, best_metrics, best_params = self._best_snapshot
            path = Path(self.config.save_path) / "best_model"
            self.write_checkpoint(path, state_dict=best_params, optimizer=False,
                                  metrics=best_metrics, epoch=best_epoch)
            self._log(f"Checkpoint saved: {path} (best epoch {best_epoch + 1})")

        if self.test_loader:
            test_metrics = self.evaluate_test_set()
            self._log("\nFinal Test Results:")
            self._log(f"Test Accuracy: {test_metrics['test_accuracy']:.4f}")
            self._log(f"Test F1 (Macro): {test_metrics['test_f1_macro']:.4f}")

        self.plot_training_curves()
        return {
            "train_losses": self.train_losses,
            "val_losses": self.val_losses,
            "val_accuracies": self.val_accuracies,
            "val_f1_scores": self.val_f1_scores,
        }

    def evaluate_test_set(self) -> Dict[str, float]:
        if not self.test_loader:
            return {}
        preds, targets, _, ids, _ = self._predict(self.test_loader, self.eval_step)
        preds, targets = dedupe_by_sample_id(ids, preds, targets)
        m = accuracy_f1(targets, preds)
        return {
            "test_accuracy": m["accuracy"],
            "test_f1_macro": m["f1_macro"],
            "test_f1_weighted": m["f1_weighted"],
        }

    # ------------------------------------------------------------- checkpoint
    def save_checkpoint(self, filename: str, epoch: int, metrics: Dict):
        path = Path(self.config.save_path) / filename
        self.write_checkpoint(path, metrics=metrics, epoch=epoch)
        self._log(f"Checkpoint saved: {path}")

    def write_checkpoint(self, path, state_dict=None, optimizer: bool = True,
                         metrics: Optional[Dict] = None, epoch: Optional[int] = None) -> None:
        """Every process: the whole state of the model (or ``state_dict``,
        a snapshot of it) and, with ``optimizer``, of the optimizer, each
        process's shards gathered over the model group; then rank 0 alone
        writes it with the train state and the config, the others waiting."""
        sd = gather_state_dict(self.model.state_dict() if state_dict is None else state_dict,
                               self.mesh)
        opt = optimizer_state(self.optimizer, self.mesh) if optimizer else None
        self.mesh.on_rank0(lambda: save_checkpoint(
            str(path), state=self.state, optimizer=opt, metrics=metrics, epoch=epoch,
            config=self.config, state_dict=sd))

    # ------------------------------------------------------------------ plots
    def plot_confusion_matrix(self, targets, predictions, epoch: int):
        self.mesh.on_rank0(lambda: self._plot_confusion_matrix(targets, predictions, epoch))

    def _plot_confusion_matrix(self, targets, predictions, epoch: int):
        plt = _pyplot()
        if plt is None:
            return
        labels = self.config.emotion_labels
        cm = confusion_matrix(targets, predictions, range(len(labels)))
        fig, ax = plt.subplots(figsize=(10, 8))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(labels)), labels, rotation=45)
        ax.set_yticks(range(len(labels)), labels)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                        color="black" if cm[i, j] < cm.max() / 2 else "white")
        ax.set_title(f"Confusion Matrix - Epoch {epoch + 1}")
        ax.set_ylabel("True Label")
        ax.set_xlabel("Predicted Label")
        fig.colorbar(im)
        path = Path(self.config.log_path) / f"confusion_matrix_epoch_{epoch + 1}.png"
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)

    def plot_training_curves(self):
        self.mesh.on_rank0(self._plot_training_curves)

    def _plot_training_curves(self):
        plt = _pyplot()
        if plt is None:
            return
        epochs = range(1, len(self.train_losses) + 1)
        fig, ((ax1, ax2), (ax3, ax4)) = plt.subplots(2, 2, figsize=(15, 10))
        ax1.plot(epochs, self.train_losses, "b-", label="Training Loss")
        ax1.plot(epochs, self.val_losses, "r-", label="Validation Loss")
        ax1.set_title("Training and Validation Loss")
        ax2.plot(epochs, self.val_accuracies, "g-", label="Validation Accuracy")
        ax2.set_title("Validation Accuracy")
        ax3.plot(epochs, self.val_f1_scores, "m-", label="Validation F1 (Macro)")
        ax3.set_title("Validation F1 Score")
        ax4.plot(epochs, self.lr_history, "c-", label="Learning Rate")
        ax4.set_title("Learning Rate Schedule")
        for ax in (ax1, ax2, ax3, ax4):
            ax.set_xlabel("Epoch")
            ax.legend()
            ax.grid(True)
        fig.tight_layout()
        path = Path(self.config.log_path) / "training_curves.png"
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)


class FewShotTrainer:
    """Episodic few-shot trainer: only the parameters named by
    ``TRAINABLE_MARKERS`` train (the rest frozen in the model), with the
    plain AdamW of ``make_trainable_only_optimizer``."""

    TRAINABLE_MARKERS = TRAINABLE_MARKERS

    def __init__(self, model, config, support_loader, query_loader,
                 n_way: Optional[int] = None, n_shot: int = 1, seed: int = 0):
        self.model = model
        self.config = config
        self.device = _model_device(model)
        self.support_loader = support_loader
        self.query_loader = query_loader
        self.n_way = n_way or config.num_emotions
        self.n_shot = n_shot
        freeze(model, lambda n: not is_trainable_name(n))
        self.optimizer = make_trainable_only_optimizer(config, model)
        self.state = TrainState.create(seed)
        self.step = make_fewshot_step(model, self.optimizer, self.n_way, self.n_shot)

    @staticmethod
    def _sort_by_label(batch):
        """The support batch ordered class by class, so that prototype i
        is class i (the reference draws it from a shuffled loader)."""
        order = np.argsort(np.asarray(batch["emotion"]), kind="stable")

        def take(x):
            if isinstance(x, np.ndarray) and x.ndim >= 1 and x.shape[0] == len(order):
                return x[order]
            return x

        return {k: ({kk: take(vv) for kk, vv in v.items()} if isinstance(v, dict) else take(v))
                for k, v in batch.items()}

    def train_few_shot_episode(self, n_way: int, n_shot: int) -> float:
        support = to_device(device_batch(self._sort_by_label(next(iter(self.support_loader)))),
                            self.device)
        query = to_device(device_batch(next(iter(self.query_loader))), self.device)
        self.state, loss = self.step(self.state, support, query)
        return float(loss)


class RobustnessTrainer(AdvancedTrainer):
    """Missing-modality training + the seven-scenario evaluation."""

    SCENARIOS = (
        (), ("text",), ("audio",), ("video",),
        ("text", "audio"), ("text", "video"), ("audio", "video"),
    )

    def __init__(self, model, config, train_loader, val_loader,
                 test_loader=None, model_type: str = "robust", **kw):
        super().__init__(model, config, train_loader, val_loader,
                         test_loader=test_loader, model_type=model_type, **kw)
        self._robust_logits_key = (
            "robust_prediction" if model_type == "robust" else "emotion_logits")
        # each modality of a batch zeroed with probability 0.3
        self.robust_train_step = make_train_step(
            model, self.optimizer, config, augment=False, compute_contrastive_loss=False,
            logits_key=self._robust_logits_key, missing_modality_rate=0.3, mesh=self.mesh)

    def train_with_missing_modalities(self) -> Dict[str, float]:
        total, n = None, 0
        self.train_loader.set_epoch(self.current_epoch)
        for batch in self._iter(self.train_loader):
            self.state, parts = self.robust_train_step(self.state, device_batch(batch))
            loss = parts["total_loss"]
            total = loss if total is None else total + loss
            n += 1
        if not n:
            return {"avg_loss": 0.0}
        return {"avg_loss": float(total) / n}

    def evaluate_robustness(self) -> Dict[str, Dict[str, float]]:
        results = {}
        for missing in self.SCENARIOS:
            name = "all" if not missing else "_".join(missing) + "_missing"
            step = make_eval_step(self.model, compute_loss=False,
                                  logits_key=self._robust_logits_key,
                                  missing_modalities=missing or None)
            preds, targets, _, ids, _ = self._predict(self.val_loader, step)
            preds, targets = dedupe_by_sample_id(ids, preds, targets)
            m = accuracy_f1(targets, preds)
            results[name] = {"accuracy": m["accuracy"], "f1_macro": m["f1_macro"]}
        return results
