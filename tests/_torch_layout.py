"""The JAX kernels' weight layouts turned into the port's, at the boundary
of the tests that hold the port's kernel wrappers to the JAX package. flax
keeps a Dense kernel as [in, out] and a Conv kernel as [K, in, out]; the
port's wrappers take torch's own layouts: ``nn.Linear`` weights [out, in],
with attention_block's q|k|v packed as one [3E, E] weight and [3E] bias,
and ``nn.Conv1d`` weights [out, in, K]. Torch and numpy only.
"""
import numpy as np
import torch


def torch_layout(*wb) -> list:
    """The port's tensors for a JAX block's (weight, bias) pairs: four pairs
    (attention_block's q, k, v, o) give [w_qkv, b_qkv, wo, bo], two
    (ffn_block's) [w1, b1, w2, b2], every weight transposed. A JAX
    gradient of those arguments maps the same way."""
    ws = [torch.from_numpy(np.ascontiguousarray(np.asarray(w).T)) for w in wb[0::2]]
    bs = [torch.from_numpy(np.ascontiguousarray(np.asarray(b))) for b in wb[1::2]]
    if len(ws) == 4:
        ws, bs = [torch.cat(ws[:3]), ws[3]], [torch.cat(bs[:3]), bs[3]]
    return [t for pair in zip(ws, bs) for t in pair]


def torch_conv(kernel) -> torch.Tensor:
    """A flax Conv kernel [K, in, out] as torch's [out, in, K]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel).transpose(2, 1, 0)))
