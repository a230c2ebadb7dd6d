"""Train and eval steps (port of simple_multimodal_tpu/train/steps.py).

One train step, in the JAX step's order: split the step's generators from
the state's, dequantise int16 audio, decode the video wire format at the
compute dtype, augment, zero missing modalities, forward in train mode
(every dropout, kernel seed, SpecAugment span and modality drop drawn from
the step's generator), the composite loss, backward (through the Hopper
kernels' backwards on CUDA), the gradient norm before clipping, and the
optimizer update. Nothing syncs with the host: the metrics stay tensors.
"""
from typing import Callable, Dict, Optional, Sequence

import torch

from ..data.augment import augment_batch
from ..data.video_wire import decode_video_wire
from .losses import cross_entropy, total_loss
from .optim import AdamWChain, global_norm
from .state import TrainState


def device_batch(batch: Dict) -> Dict:
    """Strip host-only fields from a collated batch."""
    return {k: batch[k] for k in ("text", "audio", "video", "emotion")}


def _device_generators(state: TrainState, device, n: int):
    seeds = torch.randint(0, 2 ** 62, (n,), generator=state.generator).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def make_train_step(model, optimizer: AdamWChain, config, augment: bool = False,
                    compute_contrastive_loss: bool = True,
                    logits_key: str = "emotion_logits",
                    missing_modality_rate: float = 0.0) -> Callable:
    """(state, batch) → (state, metrics) over ``model`` (on its device) and
    ``optimizer`` (made over the model's parameters). ``missing_modality_rate``
    > 0 zeroes each modality of the whole batch with that probability, the
    robustness trainer's scenario draw."""
    del config  # the JAX step reads only the compute dtype from it; the model holds it
    compute_dtype = model.dtype

    def step(state: TrainState, batch: Dict):
        device = next(model.parameters()).device
        g_aug, g_drop, g_miss = _device_generators(state, device, 3)
        audio = batch["audio"]
        if audio.dtype == torch.int16:  # wire format; dequantize on device
            audio = audio.float() / 32768.0
        video = decode_video_wire(batch["video"], compute_dtype)
        if augment:
            audio, video = augment_batch(audio, video, g_aug)
        text = batch["text"]
        if missing_modality_rate > 0:
            drop = torch.rand(3, generator=g_miss, device=device) < missing_modality_rate
            text = {k: torch.where(drop[0], torch.zeros_like(v), v) for k, v in text.items()}
            audio = torch.where(drop[1], torch.zeros_like(audio), audio)
            video = torch.where(drop[2], torch.zeros_like(video), video)
        model.train()
        outputs = model(text, audio, video, compute_contrastive_loss=compute_contrastive_loss,
                        gen=g_drop)
        loss, parts = total_loss(outputs, batch["emotion"], label_smoothing=0.1,
                                 logits_key=logits_key)
        for p in optimizer.params:
            p.grad = None
        loss.backward()
        grads = [p.grad for p in optimizer.params]
        parts = {k: v.detach() for k, v in parts.items()}
        parts["grad_norm"] = global_norm([g for g in grads if g is not None])
        optimizer.update(grads)
        for p in optimizer.params:
            p.grad = None
        return TrainState(step=state.step + 1, generator=state.generator), parts

    return step


def make_eval_step(model, compute_loss: bool = True, logits_key: str = "emotion_logits",
                   missing_modalities: Optional[Sequence[str]] = None) -> Callable:
    """batch → outputs dict (logits, probs, predictions, mean features
    [, loss]) in eval mode."""
    mm = tuple(missing_modalities) if missing_modalities else None

    @torch.no_grad()
    def step(batch: Dict) -> Dict:
        model.eval()
        outputs = model(batch["text"], batch["audio"], batch["video"], missing_modalities=mm)
        logits = outputs[logits_key]
        result = {
            "logits": logits,
            "probs": torch.softmax(logits.float(), dim=-1),
            "predictions": logits.argmax(dim=-1),
            "features": (outputs["text_features"] + outputs["audio_features"]
                         + outputs["video_features"]) / 3.0,
        }
        if compute_loss:
            result["loss"] = cross_entropy(logits, batch["emotion"], 0.1)
        return result

    return step
