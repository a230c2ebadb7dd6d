"""Evaluation (port of simple_multimodal_tpu/eval/): the metrics."""
