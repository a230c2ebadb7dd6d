"""Hand-written Hopper (sm_90a) kernels with their plain PyTorch versions.

Each wrapper (``attention_block.attention_block``, ``ffn_block.ffn_block``,
``deberta_attention.deberta_attention``, ``flash_attention.flash_attention``,
``wav_frontend.wav_frontend``, ``pos_conv.grouped_conv_same``) runs its
plain version for CPU tensors and, for CUDA tensors, a
``torch.autograd.Function`` whose forward and backward launch CUDA kernels
(built from ``csrc/`` at first use; ``grouped_conv_same``'s backward leaves
the weight gradient to cuDNN). Every wrapper takes its weights in torch
``nn.Linear`` layout, [out, in], with q|k|v packed as one [3E, E] weight
(``attention_block``); activations (``deberta_attention``'s q/k/v and
position tables, ``flash_attention``'s) are [B, S, H, D] or [rows, H·D].
A backward that reads a weight as a transposed GEMM operand copies it
itself. The forward
launches count in the wrapper's ``launches`` attribute, the backward ones
in the ``launches`` of ``*_bwd``. ``gemm`` holds the GEMM
with fused epilogues that the two blocks' chains launch, on its own, for
checks and timings, and ``gemm_linear`` on it, the DeepSeek text tower's
linear layers; it has no counter. ``adamw`` holds the optimizer's two
kernels (``foreach_sumsq``, ``foreach_adamw``), which ``train/optim.py``'s
``AdamWChain`` launches on the card; their counters are their own
``launches`` attributes, one an update each, outside ``launch_counts()``.
``moe_experts`` holds the routed experts of a DeepSeek MoE layer (the
weight cast, grouped wgmma products whose row offsets stay on the device,
fixed-order gathers), ``models/deepseek.py``'s path for them; its counter,
``moe_experts.launches``, one a layer forward, is outside
``launch_counts()`` too.
"""
from . import attention_block, deberta_attention, ffn_block, flash_attention, pos_conv, wav_frontend

KERNELS = (attention_block.attention_block, ffn_block.ffn_block,
           deberta_attention.deberta_attention, flash_attention.flash_attention,
           wav_frontend.wav_frontend, pos_conv.grouped_conv_same,
           attention_block.attention_block_bwd, ffn_block.ffn_block_bwd,
           deberta_attention.deberta_attention_bwd, flash_attention.flash_attention_bwd,
           wav_frontend.wav_frontend_bwd, pos_conv.grouped_conv_same_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
