"""Hand-written Hopper (sm_90a) kernels with their plain PyTorch versions.

Each wrapper (``attention_block.attention_block``, ``ffn_block.ffn_block``,
``deberta_attention.deberta_attention``) runs its plain version for CPU
tensors and, for CUDA tensors, a ``torch.autograd.Function`` whose forward
and backward launch CUDA kernels (built from ``csrc/`` at first use). The
forward launches count in the wrapper's ``launches`` attribute, the
backward ones in the ``launches`` of ``*_bwd``.
"""
from . import attention_block, deberta_attention, ffn_block

KERNELS = (attention_block.attention_block, ffn_block.ffn_block,
           deberta_attention.deberta_attention, attention_block.attention_block_bwd,
           ffn_block.ffn_block_bwd, deberta_attention.deberta_attention_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
