"""Bidirectional multi-layer LSTM (port of simple_multimodal_tpu/ops/lstm.py).

The JAX package writes torch ``nn.LSTM`` semantics out as a ``lax.scan``;
the port keeps ``torch.nn.LSTM``'s parameters and kernel (gate order
i, f, g, o; both directions concatenated) and runs it one layer at a time,
so that the dropout between layers (not after the last) draws its mask
from the caller's generator instead of the global RNG that
``nn.LSTM(dropout=...)`` would use. Its state-dict names
(``weight_ih_l0_reverse``, ...) are the reference's.

The LSTM always runs in f32: ``nn.LSTM`` computes in its parameters' dtype
and the port keeps f32 parameters; at 30 frames per clip the recurrence is
a small part of the forward.
"""
from typing import Optional

import torch
import torch.nn as nn

from ..parallel.tensor import weight
from .attention import dropout


class LSTM(nn.LSTM):
    """``nn.LSTM`` (batch_first) whose forward takes and returns the compute
    dtype while computing in f32."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         bidirectional=bidirectional, dropout=dropout,
                         batch_first=True)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        nd = 2 if self.bidirectional else 1
        per_layer = 4 * nd if self.bias else 2 * nd
        out = x.float()
        for layer in range(self.num_layers):
            h0 = out.new_zeros(nd, out.shape[0], self.hidden_size)
            # weight_ih sharded over the mesh's model axis is gathered whole
            weights = [weight(w, torch.float32)
                       for w in self._flat_weights[layer * per_layer:(layer + 1) * per_layer]]
            # train=True keeps cuDNN's state for a backward, needed whenever
            # gradients flow, eval mode included (the dropout here is 0)
            out = torch._VF.lstm(out, (h0, h0), weights, self.bias, 1, 0.0,
                                 torch.is_grad_enabled(), self.bidirectional, True)[0]
            if layer < self.num_layers - 1:
                out = dropout(out, self.dropout, gen, self.training)
        return out.to(x.dtype)
