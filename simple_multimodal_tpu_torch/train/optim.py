"""Optimizer and LR schedule (port of simple_multimodal_tpu/train/optim.py).

The JAX package's one optax chain, written out over the model's
parameters: global-norm clipping (optax ``clip_by_global_norm``: scale by
max/‖g‖ only when ‖g‖ ≥ max, no ε), Adam moments (b1 0.9, b2 0.999, ε 1e-8
outside the square root, bias-corrected), decoupled weight decay on every
parameter, a 0.1× scale for the pretrained backbones (decay included), and
the OneCycle schedule evaluated at the step count before the update. It is
not ``torch.optim.AdamW`` + ``clip_grad_norm_`` + ``OneCycleLR``: those clip
by max/(‖g‖ + 1e-6), decay by lr·wd outside the backbone scale and
schedule differently. Frozen subtrees (the distillation and few-shot
families) are not ported.
"""
import math
from typing import Callable, Iterable, List, Optional, Tuple

import torch

# The JAX markers (text_encoder/model, audio_encoder/model, video_encoder/vit)
# under the port's state-dict names, which models/from_jax.py maps them to.
BACKBONE_PREFIXES = ("text_encoder.model.", "audio_encoder.model.", "video_encoder.vit.")


def is_backbone_name(name: str) -> bool:
    """True for a parameter of a pretrained backbone (the 0.1× group)."""
    return name.startswith(BACKBONE_PREFIXES)


def make_schedule(learning_rate: float, total_steps: int,
                  pct_start: float = 0.1) -> Callable[[int], float]:
    """torch OneCycleLR(cos) as the JAX package joins it: linear warmup from
    lr/25 to lr over round(pct_start · total) steps, then cosine decay to
    lr/25/1e4 (optax ``linear_schedule`` + ``cosine_decay_schedule``)."""
    total_steps = max(total_steps, 2)
    warmup = min(max(int(round(total_steps * pct_start)), 1), total_steps - 1)
    init = learning_rate / 25.0
    alpha = init / 1e4 / learning_rate
    decay_steps = total_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - max(count, 0) / warmup
            return (init - learning_rate) * frac + learning_rate
        c = min(count - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return learning_rate * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient, in f32, on the gradients' device."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamWChain:
    """clip → Adam → + wd·p → ×0.1 on backbones → ×(−lr(step)), updating
    the parameters in place (the moments live here, one set per parameter)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 schedule: Callable[[int], float], clip_norm: float, weight_decay: float,
                 backbone_lr_scale: float = 0.1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.backbone = [is_backbone_name(n) for n in self.names]
        self.schedule = schedule
        self.clip_norm, self.weight_decay = clip_norm, weight_decay
        self.backbone_lr_scale = backbone_lr_scale
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: List[Optional[torch.Tensor]]) -> None:
        """One step from ``grads`` (aligned with ``params``; None counts as
        zero, as JAX's gradient of an unused parameter)."""
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        norm = global_norm(grads)
        coef = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                           self.clip_norm / norm)
        torch._foreach_mul_(grads, coef)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        upd = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        den = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        bb = [u for u, b in zip(upd, self.backbone) if b]
        if bb:
            torch._foreach_mul_(bb, self.backbone_lr_scale)
        torch._foreach_add_(self.params, upd, alpha=-lr)


def make_optimizer(config, model: torch.nn.Module, total_steps: int,
                   backbone_lr_scale: float = 0.1) -> AdamWChain:
    """AdamW + OneCycle + clip with the 0.1× backbone group, from the
    config's learning_rate, weight_decay and gradient_clip_norm."""
    return AdamWChain(model.named_parameters(),
                      make_schedule(config.learning_rate, total_steps),
                      config.gradient_clip_norm, config.weight_decay, backbone_lr_scale)
