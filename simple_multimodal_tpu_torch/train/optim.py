"""Optimizer and LR schedule (port of simple_multimodal_tpu/train/optim.py).

The JAX package's one optax chain, written out over the model's
parameters: global-norm clipping (optax ``clip_by_global_norm``: scale by
max/‖g‖ only when ‖g‖ ≥ max, no ε), Adam moments (b1 0.9, b2 0.999, ε 1e-8
outside the square root, bias-corrected), decoupled weight decay on every
parameter, a 0.1× scale for the pretrained backbones (decay included), and
the OneCycle schedule evaluated at the step count before the update. It is
not ``torch.optim.AdamW`` + ``clip_grad_norm_`` + ``OneCycleLR``: those clip
by max/(‖g‖ + 1e-6), decay by lr·wd outside the backbone scale and
schedule differently.

A frozen parameter (JAX ``freeze_mask``) is one with ``requires_grad``
off, which the model decides: the distillation model freezes its teacher
when it is built, and ``freeze`` does it by name (the few-shot episodes
freeze all but ``TRAINABLE_MARKERS``). The chain takes only the parameters
that require a gradient: no moments, no decay and no update for the rest,
and the gradient norm and clip see what JAX sees, whose frozen gradients
are exact zeros. ``make_trainable_only_optimizer`` is the few-shot
episodes' plain AdamW.

On the card the update runs in two hand-written launches
(``ops/hopper/adamw.py``: the gradients' norms, then one fused
clip-Adam-decay-update pass over every element); on the CPU it is the chain
of ``torch._foreach_*`` passes below, its plain version.
"""
import math
from typing import Callable, Iterable, List, Optional, Tuple

import torch

from ..ops.hopper import adamw
from ..parallel.tensor import model_sum, placement

# The JAX markers: a pair of consecutive names anywhere in a parameter's
# path (under ``student.``, ``teacher.`` or ``base_model.`` too), in the
# port's state-dict names, which models/from_jax.py maps the JAX paths to.
BACKBONE_MARKERS = (("text_encoder", "model"), ("audio_encoder", "model"),
                    ("video_encoder", "vit"))
# What the few-shot trainer trains (JAX ``FewShotTrainer.TRAINABLE_MARKERS``):
# a parameter whose name contains one of these.
TRAINABLE_MARKERS = ("adapter", "prompt_embeddings", "prototype_network")


def freeze(model: torch.nn.Module, predicate: Callable[[str], bool]) -> None:
    """Turn ``requires_grad`` off for every parameter whose name satisfies
    ``predicate``."""
    for name, p in model.named_parameters():
        if predicate(name):
            p.requires_grad_(False)


def is_trainable_name(name: str) -> bool:
    """True for a parameter the few-shot episodes train."""
    return any(m in name for m in TRAINABLE_MARKERS)


def is_backbone_name(name: str) -> bool:
    """True for a parameter of a pretrained backbone (the 0.1× group)."""
    keys = name.split(".")
    return any((a, b) in BACKBONE_MARKERS for a, b in zip(keys, keys[1:]))


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


def global_norm(grads: List[torch.Tensor], params: Optional[List[torch.Tensor]] = None,
                norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient, in f32, on the gradients' device.
    Where ``params`` (aligned with ``grads``) holds parameters sharded over
    a mesh's model axis, their gradients are this process's shards: their
    squares are summed over the model group and each replicated gradient,
    the same on every model process, is counted once, so every process
    clips by the whole model's norm. ``norms``: the gradients' own norms
    [n], where the caller has them (the card's ``foreach_sumsq``)."""
    if norms is None:
        norms = torch.stack(torch._foreach_norm([g.float() for g in grads]))
    tps = [placement(p) for p in params] if params is not None else []
    if not any(tps):
        return torch.linalg.vector_norm(norms)
    sharded = torch.stack([n for n, tp in zip(norms, tps) if tp]).square().sum()
    whole = [n for n, tp in zip(norms, tps) if not tp]
    total = model_sum(sharded, next(tp for tp in tps if tp).mesh)
    if whole:
        total = total + torch.stack(whole).square().sum()
    return total.sqrt()


class AdamWChain:
    """clip → Adam → + wd·p → ×0.1 on backbones → ×(−lr(step)), updating
    the parameters in place (the moments live here, one set per parameter).
    On CUDA parameters the tables of the two kernels are built here, once;
    ``fused_elements`` counts the elements the last update put through them
    (0 on the CPU)."""

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
        self.fused = (adamw.AdamWTables(self.params, self.mu, self.nu, self.backbone)
                      if self.params and self.params[0].is_cuda else None)
        self.fused_elements = 0

    @torch.no_grad()
    def update(self, grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """One step from ``grads`` (aligned with ``params``; None counts as
        zero, as JAX's gradient of an unused parameter). Returns the
        gradients' global norm before clipping. On the card the gradients
        are read, not written."""
        if self.fused is None:
            return self._chain(grads)
        t = self.fused
        table = t.grad_table(grads)
        norm = global_norm(grads, self.params, norms=adamw.foreach_sumsq(t, table))
        lr = self.schedule(self.count)
        self.count += 1
        adamw.foreach_adamw(t, table, norm, clip=self.clip_norm, lr=lr, b1=self.b1, b2=self.b2,
                            count=self.count, eps=self.eps, weight_decay=self.weight_decay,
                            backbone_scale=self.backbone_lr_scale)
        self.fused_elements = t.elements
        return norm

    @torch.no_grad()
    def _chain(self, grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """The plain version: 13 foreach passes, the gradients scaled in place."""
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(self.params, grads)]
        norm = global_norm(grads, self.params)
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
        return norm


def make_optimizer(config, model: torch.nn.Module, total_steps: int,
                   backbone_lr_scale: float = 0.1) -> AdamWChain:
    """AdamW + OneCycle + clip with the 0.1× backbone group, from the
    config's learning_rate, weight_decay and gradient_clip_norm, over the
    parameters that require a gradient."""
    return AdamWChain(model.named_parameters(),
                      make_schedule(config.learning_rate, total_steps),
                      config.gradient_clip_norm, config.weight_decay, backbone_lr_scale)


def make_trainable_only_optimizer(config, model: torch.nn.Module) -> AdamWChain:
    """Plain AdamW (optax ``adamw``'s defaults: b1 0.9, b2 0.999, ε 1e-8
    outside the square root, weight decay 1e-4, no clip) at the config's
    constant learning_rate over the parameters that require a gradient:
    the few-shot episodes freeze every name but ``TRAINABLE_MARKERS``'
    first (``freeze(model, lambda n: not is_trainable_name(n))``)."""
    lr = config.learning_rate
    return AdamWChain(model.named_parameters(), lambda count: lr, clip_norm=math.inf,
                      weight_decay=1e-4, backbone_lr_scale=1.0)
