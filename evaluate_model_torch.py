#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port (simple_multimodal_tpu_torch).

Takes ``evaluate_model.py``'s flags: loads a port checkpoint directory,
evaluates a split, prints the summary metrics, and writes the seven plot
families (where matplotlib is present), ``evaluation_report.html`` and
``detailed_results.json``. ``--assert_f1_band LO,HI`` exits 3 when the
F1-macro falls outside [LO, HI].

Runs on the card: ``--device`` defaults to ``cuda``; ``auto`` means
``cuda`` too, and both raise without a CUDA device. ``--device cpu`` runs
on the CPU.

    python evaluate_model_torch.py --model_path checkpoints/final_model_hierarchical \\
        --data_path data/sample --dataset sample --split test
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate Multimodal Emotion Recognition Model (PyTorch port)")
    parser.add_argument("--model_path", type=str, required=True,
                        help="Path to trained model checkpoint directory")
    parser.add_argument("--config_path", type=str,
                        help="Path to model configuration JSON")
    parser.add_argument("--data_path", type=str, default="./data")
    parser.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--output_dir", type=str, default="./evaluation_results")
    parser.add_argument("--dataset", type=str, default="cmu_mosei",
                        choices=["cmu_mosei", "meld", "iemocap", "multimodal", "sample"])
    parser.add_argument("--preset", type=str, default=None, choices=["tiny", "half", "base"],
                        help="Override encoder preset (else from saved config)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or auto: the card, raising without one; "
                             "cpu: the CPU")
    parser.add_argument("--assert_f1_band", type=str, default=None, metavar="LO,HI",
                        help="Exit 3 unless LO <= F1-macro <= HI: a collapsed score and a "
                             "suspiciously perfect one both fail the band")
    return parser


def main(argv=None):
    """Returns the evaluator's results; exits 3 outside ``--assert_f1_band``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    band = None
    if args.assert_f1_band:
        try:
            lo, hi = (float(x) for x in args.assert_f1_band.split(","))
        except ValueError:
            parser.error("--assert_f1_band expects LO,HI (e.g. 0.5,0.98)")
        if not 0.0 <= lo <= hi <= 1.0:
            parser.error("--assert_f1_band needs 0 <= LO <= HI <= 1")
        band = (lo, hi)

    from simple_multimodal_tpu_torch.data.dataset import create_dataloader, get_dataset
    from simple_multimodal_tpu_torch.eval.evaluator import ModelEvaluator

    device = "cuda" if args.device == "auto" else args.device
    evaluator = ModelEvaluator(args.model_path, args.config_path, device=device)
    if args.preset:
        evaluator.config.encoder_preset = args.preset
    evaluator.config.data_path = args.data_path

    print(f"Loading {args.dataset} dataset ({args.split} split)...")
    dataset = get_dataset(dataset_name=args.dataset, data_path=args.data_path,
                          split=args.split, config=evaluator.config, augment=False)
    data_loader = create_dataloader(dataset, batch_size=args.batch_size, shuffle=False)
    print(f"Evaluating on {len(dataset)} samples...")

    results = evaluator.evaluate_dataset(data_loader)

    print("\n" + "=" * 50)
    print("EVALUATION RESULTS")
    print("=" * 50)
    m = results["metrics"]
    print(f"Accuracy: {m['accuracy']:.4f}")
    print(f"F1-Score (Macro): {m['f1_macro']:.4f}")
    print(f"F1-Score (Weighted): {m['f1_weighted']:.4f}")
    print(f"Precision (Macro): {m['precision_macro']:.4f}")
    print(f"Recall (Macro): {m['recall_macro']:.4f}")
    if m["roc_auc"]:
        print(f"ROC AUC: {m['roc_auc']:.4f}")
    if results["individual_metrics"]:
        print("\nIndividual Modality Performance:")
        for modality, im in results["individual_metrics"].items():
            print(f"  {modality.title()}: Acc={im['accuracy']:.3f}, F1={im['f1_macro']:.3f}")

    output_path = Path(args.output_dir)
    output_path.mkdir(parents=True, exist_ok=True)
    evaluator.create_visualizations(results, args.output_dir)
    evaluator.generate_report(results, args.output_dir)
    results_path = evaluator.save_detailed_results(results, args.output_dir)
    print(f"\nDetailed results saved to: {results_path}")
    print(f"All evaluation outputs saved to: {output_path}")
    if band is not None:
        lo, hi = band
        f1 = m["f1_macro"]
        if not lo <= f1 <= hi:
            print(f"F1 BAND VIOLATION: f1_macro={f1:.4f} outside [{lo}, {hi}]", file=sys.stderr)
            sys.exit(3)
        print(f"F1 band OK: {f1:.4f} in [{lo}, {hi}]")
    return results


if __name__ == "__main__":
    main()
