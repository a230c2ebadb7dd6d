"""Training losses (port of simple_multimodal_tpu/train/losses.py).

The reference trainer's composite loss: label-smoothed cross-entropy (0.1)
on the emotion logits, + 0.1 × the summed pairwise contrastive losses,
+ 0.1 × the auxiliary valence/arousal MSE, + 0.5 × a distillation loss.
As in the reference, the auxiliary term is dead by default: it engages
only when targets are given.
"""
from typing import Dict, Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over the batch with torch-style label smoothing, in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(dim=-1)
    return nll.mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred.float() - target.float()) ** 2).mean()


def total_loss(outputs: Dict[str, torch.Tensor], emotion_targets: torch.Tensor,
               label_smoothing: float = 0.1, contrastive_weight: float = 0.1,
               aux_weight: float = 0.1, distill_weight: float = 0.5,
               valence_targets: Optional[torch.Tensor] = None,
               arousal_targets: Optional[torch.Tensor] = None,
               logits_key: str = "emotion_logits"):
    """The reference's composite training loss; returns (loss, parts)."""
    main = cross_entropy(outputs[logits_key], emotion_targets, label_smoothing)
    zero = torch.zeros((), dtype=torch.float32, device=main.device)
    contrastive = zero
    for v in (outputs.get("contrastive_losses") or {}).values():
        contrastive = contrastive + v
    aux = zero
    if valence_targets is not None and "valence" in outputs:
        aux = aux + mse(outputs["valence"][:, 0], valence_targets)
    if arousal_targets is not None and "arousal" in outputs:
        aux = aux + mse(outputs["arousal"][:, 0], arousal_targets)
    distill = outputs.get("distillation_loss", zero)
    loss = main + contrastive_weight * contrastive + aux_weight * aux + distill_weight * distill
    parts = {"total_loss": loss, "emotion_loss": main, "contrastive_loss": contrastive,
             "auxiliary_loss": aux, "distillation_loss": distill}
    return loss, parts
