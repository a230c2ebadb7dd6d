"""Train state (port of simple_multimodal_tpu/train/state.py): the step
count and the generator every per-step generator is split from. The
parameters live in the model and the moments in the optimizer."""
import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    generator: torch.Generator  # on the CPU: it only seeds per-step generators

    @classmethod
    def create(cls, seed: int) -> "TrainState":
        return cls(step=0, generator=torch.Generator().manual_seed(seed))
