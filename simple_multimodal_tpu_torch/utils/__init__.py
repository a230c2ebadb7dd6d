"""Utilities (port of simple_multimodal_tpu/utils/): profiling."""
