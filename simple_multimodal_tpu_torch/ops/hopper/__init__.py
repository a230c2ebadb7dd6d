"""Hand-written Hopper (sm_90a) kernels with their plain PyTorch versions.

Each wrapper (``attention_block.attention_block``, ``ffn_block.ffn_block``,
``deberta_attention.deberta_attention``) runs its plain version for CPU
tensors and launches its CUDA kernel (built from ``csrc/`` at first use)
for CUDA tensors, counting the launches in its ``launches`` attribute.
"""
from . import attention_block, deberta_attention, ffn_block

KERNELS = (attention_block.attention_block, ffn_block.ffn_block,
           deberta_attention.deberta_attention)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
