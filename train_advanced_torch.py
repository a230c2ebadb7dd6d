#!/usr/bin/env python
"""Advanced training CLI of the PyTorch port (simple_multimodal_tpu_torch).

Takes ``train_advanced.py``'s flags: ``--mode``, ``--fusion_type``, the
paths, batch size, epochs, learning rate, seed, wandb, ``--preset``,
``--episodes``, ``--few_shot_samples``, ``--resume``, ``--dataset``,
``--mesh``. ``--text_model_name moonshotai/Moonlight-16B-A3B`` (with
``--text_num_layers`` and ``--text_expert_share index,count``) trains the
DeepSeek-V3 decoder as the text tower (``models/deepseek.py``); it runs
under ``--mesh d,1`` and a model axis above 1 refuses it before anything is
loaded. The JAX package's TPU-only flags (``--flash_attention``,
``--flash_attention_train``, ``--remat``) are accepted and written to
``final_config.json`` unread.

Runs on the card: ``--device`` defaults to ``cuda``; ``auto`` means
``cuda`` too, and both raise without a CUDA device. ``--device cpu`` runs
on the CPU (bf16 compute on the card, f32 on the CPU).

``--mesh d,m`` trains over d·m processes, one a card, launched by
``torchrun --nproc_per_node=d·m`` (NCCL on the cards, gloo with ``--device
cpu``): data-parallel over d (``--batch_size`` stays the global batch, each
data shard takes its rows, the gradients are averaged over the data shards
and the schedule counts global steps) and tensor-parallel over m (the
parameters and Adam moments that the JAX rule shards are stored sharded
over the m processes of a data shard, gathered whole for the blocks, and
DeBERTa's attention heads split over them), so the run trains the same
model, step for step, as ``--mesh 1,1`` on one card. Under ``torchrun``,
``--device cuda`` is ``cuda:LOCAL_RANK`` and rank 0 alone writes
checkpoints (the whole state, which resumes under any mesh) and reports.
d·m must equal the number of processes, and m must divide DeBERTa's 12
heads (and the sharded widths: m in 1, 2, 3, 4, 6 at ``base``). Without
``torchrun``, ``--mesh 1,1`` (the default) is one process on one card::

    torchrun --standalone --nproc_per_node=8 train_advanced_torch.py --mesh 4,2 \\
        --data_path data/sample --preset base --batch_size 16 --epochs 2

Every mode of ``train_advanced.py`` runs: ``standard``, ``few_shot``,
``distillation`` (the teacher from a port checkpoint directory given by
``--teacher_model``; the student saved weights-only to
``distilled_student_model``), ``robust``, ``ablation`` and ``all``.
``main`` returns what it trained; under ``--mode all`` also ``errors``
(experiment → message), empty when every part ran, where the JAX CLI only
prints the failures.

    python train_advanced_torch.py --mode standard --data_path data/sample \\
        --preset base --fusion_type hierarchical --batch_size 8 --epochs 2
    python train_advanced_torch.py --mode distillation --data_path data/sample \\
        --teacher_model checkpoints/final_model_hierarchical --epochs 1
"""
import argparse
import copy
import json
import os
import random
import sys
from pathlib import Path
from typing import Dict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from simple_multimodal_tpu_torch.config import (  # noqa: E402
    DataConfig, ExperimentConfig, ModelConfig, config_to_dict,
)

def set_seed(seed: int = 42) -> None:
    """Seed the host RNGs; the device generators are split from the seed."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_device(name: str):
    """The device of ``--device``: 'cuda' and 'auto' need a CUDA device and
    raise without one (under ``torchrun``: this process's card,
    ``cuda:LOCAL_RANK``); 'cpu' only on request."""
    import torch
    import torch.distributed as dist

    from simple_multimodal_tpu_torch.parallel.mesh import local_device

    device = torch.device("cuda" if name in ("auto", "cuda") else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"train_advanced_torch: --device {name} needs a CUDA device and "
                           "none is available; pass --device cpu to train on the CPU")
    return local_device(device) if dist.is_initialized() else device


def load_datasets(data_config: DataConfig, model_config: ModelConfig,
                  seed: int = 0) -> Dict:
    from simple_multimodal_tpu_torch.data.dataset import create_dataloader, get_dataset

    print("Loading datasets...")
    loaders = {}
    counts = {}
    for split in ("train", "val", "test"):
        ds = get_dataset(
            dataset_name=data_config.primary_dataset,
            data_path=model_config.data_path,
            split=split,
            config=model_config,
            augment=data_config.augment_data if split == "train" else False,
        )
        loaders[split] = create_dataloader(
            ds, batch_size=model_config.batch_size,
            shuffle=(split == "train"), seed=seed,
        )
        counts[split] = len(ds)
    print(f"Train samples: {counts['train']}")
    print(f"Val samples: {counts['val']}")
    print(f"Test samples: {counts['test']}")
    return loaders


def _generator(seed: int):
    import torch

    return torch.Generator().manual_seed(seed)


def train_standard_model(model_config: ModelConfig, data_config: DataConfig, device,
                         fusion_type: str = "hierarchical", seed: int = 0,
                         resume_from: str = None):
    """Train, then save ``final_model_<fusion>``; returns (path, trainer)."""
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.trainer import AdvancedTrainer

    print(f"=== Training Standard Model with {fusion_type} fusion ===")
    model_config.fusion_type = fusion_type
    loaders = load_datasets(data_config, model_config, seed)
    model = create_model(model_config, model_type="standard", device=device,
                         generator=_generator(seed))
    trainer = AdvancedTrainer(
        model=model, config=model_config,
        train_loader=loaders["train"], val_loader=loaders["val"],
        test_loader=loaders["test"], seed=seed, resume_from=resume_from,
    )
    trainer.train()
    model_path = Path(model_config.save_path) / f"final_model_{fusion_type}"
    trainer.write_checkpoint(model_path, metrics={}, epoch=trainer.current_epoch)
    print(f"Model saved to: {model_path}")
    return str(model_path), trainer


def train_few_shot_model(model_config: ModelConfig, data_config: DataConfig,
                         experiment_config: ExperimentConfig, device,
                         seed: int = 0, num_episodes: int = 100) -> Dict[str, float]:
    from simple_multimodal_tpu_torch.data.dataset import (FewShotDataset, create_dataloader,
                                                          get_dataset)
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.trainer import FewShotTrainer

    print("=== Few-Shot Learning Experiments ===")
    results = {}
    train_dataset = get_dataset(data_config.primary_dataset,
                                model_config.data_path, "train", model_config)
    val_dataset = get_dataset(data_config.primary_dataset,
                              model_config.data_path, "val", model_config)

    # the prototypes need exactly n_shot clips of every class: clamp each
    # sweep point to the scarcest class
    class_counts = {}
    for row in train_dataset.data:
        cid = train_dataset.emotion_to_id[row["emotion"]]
        class_counts[cid] = class_counts.get(cid, 0) + 1
    min_count = min(
        (class_counts.get(c, 0) for c in range(model_config.num_emotions)),
        default=0,
    )
    if min_count == 0:
        print("Few-shot skipped: some emotion class has no train samples")
        return results

    for n_shot in experiment_config.few_shot_samples:
        print(f"Training {n_shot}-shot model...")
        n_shot_eff = min(n_shot, min_count)
        few_shot_train = FewShotDataset(train_dataset, n_shot=n_shot_eff,
                                        n_way=model_config.num_emotions)
        few_shot_val = FewShotDataset(val_dataset, n_shot=n_shot_eff,
                                      n_way=model_config.num_emotions)
        # shuffled loaders: every episode draws a fresh support order and
        # another query batch; the trainer sorts the support by label
        support_loader = create_dataloader(
            few_shot_train, batch_size=len(few_shot_train), shuffle=True, seed=seed)
        query_loader = create_dataloader(
            few_shot_val, batch_size=min(16, max(len(few_shot_val), 1)),
            shuffle=True, seed=seed)
        model = create_model(model_config, model_type="few_shot", device=device,
                             generator=_generator(seed))
        trainer = FewShotTrainer(
            model=model, config=model_config,
            support_loader=support_loader, query_loader=query_loader,
            n_way=model_config.num_emotions, n_shot=n_shot_eff, seed=seed,
        )
        total_loss = 0.0
        for episode in range(num_episodes):
            loss = trainer.train_few_shot_episode(
                n_way=model_config.num_emotions, n_shot=n_shot_eff)
            total_loss += loss
            if (episode + 1) % 20 == 0:
                print(f"Episode {episode + 1}/{num_episodes}, Loss: {loss:.4f}")
        avg = total_loss / num_episodes
        results[f"{n_shot}_shot"] = avg
        print(f"{n_shot}-shot average loss: {avg:.4f}")
    return results


def train_robust_model(model_config: ModelConfig, data_config: DataConfig,
                       experiment_config: ExperimentConfig, device,
                       seed: int = 0) -> Dict[str, Dict[str, float]]:
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.trainer import RobustnessTrainer

    print("=== Robustness Training ===")
    loaders = load_datasets(data_config, model_config, seed)
    robust_model = create_model(model_config, model_type="robust", device=device,
                                generator=_generator(seed))
    trainer = RobustnessTrainer(
        model=robust_model, config=model_config,
        train_loader=loaders["train"], val_loader=loaders["val"],
        test_loader=loaders["test"], model_type="robust", seed=seed,
    )
    print("Training with random modality dropout...")
    for epoch in range(max(model_config.num_epochs // 2, 1)):
        trainer.current_epoch = epoch
        metrics = trainer.train_with_missing_modalities()
        print(f"Epoch {epoch + 1}, Loss: {metrics['avg_loss']:.4f}")

    print("Evaluating robustness...")
    results = trainer.evaluate_robustness()
    print("Robustness Results:")
    for scenario, m in results.items():
        print(f"{scenario}: Accuracy={m['accuracy']:.3f}, F1={m['f1_macro']:.3f}")
    robust_path = Path(model_config.save_path) / "robust_model"
    trainer.write_checkpoint(robust_path, metrics={}, epoch=trainer.current_epoch)
    return results


def train_knowledge_distillation(model_config: ModelConfig, data_config: DataConfig, device,
                                 teacher_model_path: str, seed: int = 0):
    """A student with the fusion stack halved, trained against the frozen
    teacher restored from ``teacher_model_path``; the student alone saved
    to ``distilled_student_model``. Returns (path, trainer)."""
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.parallel.tensor import gather_state_dict
    from simple_multimodal_tpu_torch.train.checkpoint import (read_meta, restore_params,
                                                              save_params)
    from simple_multimodal_tpu_torch.train.trainer import AdvancedTrainer

    print("=== Knowledge Distillation Training ===")
    loaders = load_datasets(data_config, model_config, seed)
    teacher_state = restore_params(teacher_model_path)
    # the teacher's fusion comes from its own saved config
    meta_cfg = read_meta(teacher_model_path).get("config") or {}
    if meta_cfg.get("fusion_type"):
        model_config.fusion_type = meta_cfg["fusion_type"]

    # the student: the fusion stack halved
    student_config = copy.deepcopy(model_config)
    student_config.fusion_hidden_size = model_config.fusion_hidden_size // 2
    student_config.fusion_num_heads = max(model_config.fusion_num_heads // 2, 1)
    student_config.fusion_num_layers = max(model_config.fusion_num_layers // 2, 1)

    model = create_model(model_config, model_type="distillation", device=device,
                         generator=_generator(seed), student_config=student_config)
    model.teacher.load_state_dict(teacher_state)  # strict: every key, no other
    trainer = AdvancedTrainer(
        model=model, config=student_config,
        train_loader=loaders["train"], val_loader=loaders["val"],
        test_loader=loaders["test"], model_type="distillation", seed=seed,
    )
    trainer.train()
    student_path = Path(model_config.save_path) / "distilled_student_model"
    student = gather_state_dict(model.student.state_dict(), trainer.mesh)  # every rank
    trainer.mesh.on_rank0(lambda: save_params(str(student_path), student))
    print(f"Distilled model saved to: {student_path}")
    return str(student_path), trainer


def run_ablation_studies(model_config: ModelConfig, data_config: DataConfig,
                         experiment_config: ExperimentConfig, device,
                         seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Each fusion that ``experiment_config`` enables, trained for
    min(10, epochs) epochs on fresh loaders: {fusion: {val_accuracy, val_f1}}."""
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model
    from simple_multimodal_tpu_torch.train.trainer import AdvancedTrainer

    print("=== Ablation Studies ===")
    fusion_methods = [name for name, on in (
        ("early", experiment_config.enable_early_fusion),
        ("late", experiment_config.enable_late_fusion),
        ("mult", experiment_config.enable_mult_fusion),
        ("graph", experiment_config.enable_graph_fusion),
        ("contrastive", experiment_config.enable_contrastive_learning),
    ) if on]

    results = {}
    for fusion_type in fusion_methods:
        print(f"Testing {fusion_type} fusion...")
        temp = copy.deepcopy(model_config)
        temp.fusion_type = fusion_type
        temp.num_epochs = min(10, model_config.num_epochs)
        loaders = load_datasets(data_config, temp, seed)
        model = create_model(temp, model_type="standard", device=device,
                             generator=_generator(seed))
        trainer = AdvancedTrainer(
            model=model, config=temp,
            train_loader=loaders["train"], val_loader=loaders["val"],
            test_loader=loaders["test"], seed=seed,
        )
        trainer.train()
        results[fusion_type] = {
            "val_accuracy": trainer.best_val_acc,
            "val_f1": trainer.best_val_f1,
        }
        print(f"{fusion_type} - Val Acc: {trainer.best_val_acc:.3f}, "
              f"Val F1: {trainer.best_val_f1:.3f}")
    return results


ALL_STANDARD_FUSIONS = ("early", "late", "mult", "graph", "contrastive", "hierarchical")


def run_all_experiments(model_config: ModelConfig, data_config: DataConfig,
                        experiment_config: ExperimentConfig, device, seed: int = 0,
                        num_episodes: int = 100):
    """Six standard fusions, then few-shot, robust and ablation, each
    isolated: a failure is printed and the rest still run. Returns
    (results, errors), each keyed by experiment."""
    print("Running comprehensive experiments...")
    results: Dict = {}
    errors: Dict[str, str] = {}

    def attempt(name: str, what: str, run, done):
        try:
            results[name] = run()
            print(done(results[name]))
        except Exception as e:  # per-experiment isolation, as the JAX CLI
            errors[name] = str(e)
            print(f"Error in {what}: {e}")

    for fusion_type in ALL_STANDARD_FUSIONS:
        attempt(fusion_type, f"{fusion_type} fusion",
                lambda f=fusion_type: train_standard_model(model_config, data_config, device,
                                                           f, seed)[0],
                lambda _, f=fusion_type: f"Completed {f} fusion training")
    attempt("few_shot", "few-shot learning",
            lambda: train_few_shot_model(model_config, data_config, experiment_config, device,
                                         seed, num_episodes),
            lambda r: f"Few-shot results: {r}")
    attempt("robust", "robustness training",
            lambda: train_robust_model(model_config, data_config, experiment_config, device,
                                       seed),
            lambda r: f"Robustness results: {r}")
    attempt("ablation", "ablation studies",
            lambda: run_ablation_studies(model_config, data_config, experiment_config, device,
                                         seed),
            lambda r: f"Ablation results: {r}")
    return results, errors


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Advanced Multimodal Emotion Recognition Training (PyTorch port)")
    parser.add_argument("--mode", type=str, default="standard",
                        choices=["standard", "few_shot", "distillation",
                                 "robust", "ablation", "all"],
                        help="Training mode")
    parser.add_argument("--fusion_type", type=str, default="hierarchical",
                        choices=["early", "late", "mult", "graph",
                                 "contrastive", "adaptive", "hierarchical"],
                        help="Fusion strategy")
    parser.add_argument("--data_path", type=str, default="./data")
    parser.add_argument("--save_path", type=str, default="./checkpoints")
    parser.add_argument("--teacher_model", type=str,
                        help="Teacher model path for distillation")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or auto: the card, raising without one; "
                             "cpu: the CPU")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--wandb_project", type=str, default="multimodal-emotion")
    parser.add_argument("--preset", type=str, default="base",
                        choices=["tiny", "half", "base"],
                        help="Encoder backbone scale")
    parser.add_argument("--mesh", type=str, default="1,1",
                        help="Mesh 'data,model': data x model processes "
                             "(torchrun --nproc_per_node=data*model), one a card; model "
                             "must divide DeBERTa's heads, and be 1 for the Moonlight tower")
    parser.add_argument("--text_model_name", type=str, default="microsoft/deberta-v3-base",
                        help="Text backbone: DeBERTa-v3, or moonshotai/Moonlight-16B-A3B for "
                             "the DeepSeek-V3 decoder (models/deepseek.py)")
    parser.add_argument("--text_num_layers", type=int, default=0,
                        help="Moonlight: the decoder layers kept (0: the published 27)")
    parser.add_argument("--text_expert_share", type=str, default="0,1",
                        help="Moonlight: 'index,count', this process's block of each MoE "
                             "layer's routed experts, as one of count expert-parallel ranks")
    parser.add_argument("--episodes", type=int, default=100,
                        help="Few-shot episodes per n_shot")
    parser.add_argument("--few_shot_samples", type=int, nargs="+", default=None,
                        help="Override the n_shot sweep (default 1 5 10 20 50)")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint directory to resume training from "
                             "(parameters, optimizer, step and generator)")
    parser.add_argument("--dataset", type=str, default=None,
                        help="Override primary dataset name")
    parser.add_argument("--flash_attention", type=str, default="auto",
                        help="JAX kernel switch: recorded, not read")
    parser.add_argument("--flash_attention_train", type=str, default="auto",
                        help="JAX kernel switch: recorded, not read")
    parser.add_argument("--remat", type=str, default="auto", choices=["auto", "0", "1"],
                        help="JAX remat switch: recorded, not read")
    return parser


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    if args.mode == "distillation" and not args.teacher_model:
        print("Error: Teacher model path required for distillation")
        return {"mode": args.mode}
    from simple_multimodal_tpu_torch.models.deberta import DebertaConfig
    from simple_multimodal_tpu_torch.models.deepseek import MOONLIGHT, DeepseekConfig, DeepseekModel
    from simple_multimodal_tpu_torch.parallel.mesh import (initialize_distributed, mesh_axes,
                                                           process_index)
    from simple_multimodal_tpu_torch.parallel.tensor import check_heads, refuse_model_axis

    mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    # raise before anything is written or loaded on a shape the model or the
    # processes do not make (the preset's DeBERTa heads, as resolve_backbone_configs;
    # the Moonlight tower has no model-axis rule)
    if args.text_model_name == MOONLIGHT:
        names = [n for n, _ in DeepseekModel(DeepseekConfig.tiny()).named_parameters()]
        refuse_model_axis(mesh_shape[1], "text_encoder.model (Moonlight)", names)
    else:
        text = {"tiny": DebertaConfig.tiny, "half": DebertaConfig.half}.get(args.preset,
                                                                             DebertaConfig.base)()
        check_heads(mesh_shape[1], text.num_heads, "DeBERTa")
    initialize_distributed(device="cpu" if args.device == "cpu" else "cuda")
    mesh_axes(mesh_shape)
    device = resolve_device(args.device)
    set_seed(args.seed)

    model_config = ModelConfig(data_path=args.data_path, save_path=args.save_path,
                               text_model_name=args.text_model_name,
                               text_num_layers=args.text_num_layers,
                               text_expert_share=tuple(int(x) for x in
                                                       args.text_expert_share.split(",")))

    model_config.batch_size = args.batch_size
    model_config.num_epochs = args.epochs
    model_config.learning_rate = args.learning_rate
    model_config.device = args.device
    model_config.use_wandb = args.use_wandb
    model_config.fusion_type = args.fusion_type
    model_config.encoder_preset = args.preset
    model_config.mesh_shape = mesh_shape
    model_config.flash_attention = args.flash_attention
    model_config.flash_attention_train = args.flash_attention_train
    model_config.remat_encoders = ("auto" if args.remat == "auto" else args.remat == "1")

    data_config = DataConfig()
    if args.dataset:
        data_config.primary_dataset = args.dataset
    experiment_config = ExperimentConfig()
    if args.few_shot_samples:
        experiment_config.few_shot_samples = args.few_shot_samples

    os.makedirs(args.save_path, exist_ok=True)
    result: Dict = {"mode": args.mode}
    if args.mode == "standard":
        path, trainer = train_standard_model(model_config, data_config, device,
                                             args.fusion_type, args.seed,
                                             resume_from=args.resume)
        print(f"Training completed! Model saved to: {path}")
        result.update(path=path, trainer=trainer)
    elif args.mode == "few_shot":
        results = train_few_shot_model(model_config, data_config, experiment_config,
                                       device, args.seed, args.episodes)
        print(f"Few-shot learning results: {results}")
        result.update(results=results)
    elif args.mode == "distillation":
        path, trainer = train_knowledge_distillation(model_config, data_config, device,
                                                     args.teacher_model, args.seed)
        print(f"Distillation completed! Student model saved to: {path}")
        result.update(path=path, trainer=trainer)
    elif args.mode == "robust":
        results = train_robust_model(model_config, data_config, experiment_config,
                                     device, args.seed)
        print(f"Robustness training completed! Results: {results}")
        result.update(results=results)
    elif args.mode == "ablation":
        results = run_ablation_studies(model_config, data_config, experiment_config,
                                       device, args.seed)
        print(f"Ablation studies completed! Results: {results}")
        result.update(results=results)
    elif args.mode == "all":
        results, errors = run_all_experiments(model_config, data_config, experiment_config,
                                              device, args.seed, args.episodes)
        result.update(results=results, errors=errors)

    config_save_path = Path(args.save_path) / "final_config.json"
    if process_index() == 0:
        with open(config_save_path, "w") as f:
            json.dump({
                "model_config": config_to_dict(model_config),
                "data_config": config_to_dict(data_config),
                "experiment_config": config_to_dict(experiment_config),
            }, f, indent=2)
        print(f"Configuration saved to: {config_save_path}")
    return result


if __name__ == "__main__":
    from simple_multimodal_tpu_torch.parallel.mesh import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
