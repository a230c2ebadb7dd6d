#!/usr/bin/env bash
# Convergence of the PyTorch port on the card: the sample set at difficulty
# 0.5 (13 clips per emotion: 63 train, 13 val, 15 test), the base
# hierarchical model trained at B=8 for 15 epochs with three seeds, each
# final model evaluated on the test split by evaluate_model_torch.py.
#
#   bash tools/convergence_torch.sh [WORKDIR] [SEED ...]
#
# WORKDIR (default: a new temporary directory) holds the set, the
# evaluations and, until its evaluation, each seed's checkpoints (about
# 6 GB); the last lines print each seed's test accuracy and F1-macro. Run
# from the repository root.
set -euo pipefail
work=${1:-$(mktemp -d)}
if [ $# -gt 1 ]; then seeds=("${@:2}"); else seeds=(42 43 44); fi
python create_sample_data_torch.py --output_dir "$work/data" --num_samples 13 --difficulty 0.5
summary=()
for seed in "${seeds[@]}"; do
    start=$(date +%s)
    python train_advanced_torch.py --mode standard --preset base --fusion_type hierarchical \
        --batch_size 8 --epochs 15 --seed "$seed" --data_path "$work/data" \
        --save_path "$work/ck_$seed"
    python evaluate_model_torch.py --model_path "$work/ck_$seed/final_model_hierarchical" \
        --data_path "$work/data" --dataset sample --split test --batch_size 8 \
        --output_dir "$work/eval_$seed" | tee "$work/eval_$seed.log"
    f1=$(sed -n 's/^F1-Score (Macro): //p' "$work/eval_$seed.log")
    acc=$(sed -n 's/^Accuracy: //p' "$work/eval_$seed.log")
    rm -rf "$work/ck_$seed"
    summary+=("convergence seed $seed: test accuracy $acc F1-macro $f1 ($(( $(date +%s) - start )) s)")
done
printf '%s\n' "${summary[@]}"
