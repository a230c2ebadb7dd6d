"""Parameter-efficient tuning block (port of simple_multimodal_tpu/ops/adapters.py).

``AdapterLayer`` is the residual bottleneck the few-shot family places after
each backbone: down → ReLU → dropout → up, plus the input. Its two kernels
start N(0, 0.02) with zero biases (``models.multimodal_model.init_weights``
gives them that case). The modality dropout of the same JAX module lives in
``models/multimodal_model.py``.
"""
import torch
import torch.nn as nn

from .attention import dropout, linear


class AdapterLayer(nn.Module):
    def __init__(self, hidden_size: int, adapter_size: int, rate: float = 0.1):
        super().__init__()
        self.down_project = nn.Linear(hidden_size, adapter_size)
        self.up_project = nn.Linear(adapter_size, hidden_size)
        self.rate = rate

    def forward(self, x: torch.Tensor, dtype, gen=None) -> torch.Tensor:
        h = torch.relu(linear(x, self.down_project, dtype))
        h = dropout(h, self.rate, gen, self.training)
        return x + linear(h, self.up_project, dtype)
