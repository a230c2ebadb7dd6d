"""simple_multimodal_tpu_torch — the PyTorch/CUDA port of simple_multimodal_tpu.

The serving slice of the JAX package (config, video wire decode, the three
backbones, hierarchical fusion, the model and the demo) in PyTorch, with
the TPU Pallas kernels on that path replaced by hand-written Hopper kernels
(``ops/hopper`` over ``csrc/``). Imports torch and never jax.
"""

__version__ = "0.1.0"
