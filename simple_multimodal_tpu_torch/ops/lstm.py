"""Bidirectional multi-layer LSTM (port of simple_multimodal_tpu/ops/lstm.py).

The JAX package writes torch ``nn.LSTM`` semantics out as a ``lax.scan``;
the port uses ``torch.nn.LSTM`` itself (gate order i, f, g, o; dropout
between layers, not after the last; both directions concatenated). Its
state-dict names (``weight_ih_l0_reverse``, ...) are the reference's.

The LSTM always runs in f32: ``nn.LSTM`` computes in its parameters' dtype
and the port keeps f32 parameters; at 30 frames per clip the recurrence is
a small part of the forward.
"""
import torch
import torch.nn as nn


class LSTM(nn.LSTM):
    """``nn.LSTM`` (batch_first) whose forward takes and returns the compute
    dtype while computing in f32."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         bidirectional=bidirectional, dropout=dropout,
                         batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = super().forward(x.float())
        return out.to(x.dtype)
