"""Train and eval steps (port of simple_multimodal_tpu/train/steps.py).

One train step, in the JAX step's order: split the step's generators from
the state's, dequantise int16 audio, decode the video wire format at the
compute dtype, augment, zero missing modalities, forward in train mode
(every dropout, kernel seed, SpecAugment span and modality drop drawn from
the step's generator), the composite loss, backward (through the Hopper
kernels' backwards on CUDA), the gradient norm before clipping, and the
optimizer update. Nothing syncs with the host: the metrics stay tensors.
``make_fewshot_step`` is the prototypical episode's step.

Under a data-parallel mesh (``parallel/mesh.py``) the batch holds this
rank's rows of the global batch and the step computes what the
single-process step computes on the whole batch, as under the JAX mesh:
the step's generators are the same on every rank, every draw with a batch
axis is the global batch's (this rank's rows kept), the contrastive loss
takes the global batch's negatives, the gradients are averaged over the
data group (one all-reduce of their concatenation) before the norm, the
clip and the update, and the reported loss parts are the global batch's.
Under a model axis (``parallel/tensor.py``) the gradients of sharded
parameters are this process's shards, the norm sums their squares over the
model group, and the replicated parameters' gradients are made the same on
every model process (``sync_replicated_``). Without a process group none of
that adds a collective or a larger draw.

While a profiler records, a train step is the span ``smm.train_step`` and
its phases the spans ``smm.forward`` (generators through the loss),
``smm.backward`` (the gradients, with the mesh's reductions) and
``smm.optimizer`` (norm, clip, update), through ``utils/profiling.py``'s
``annotate``; with none recording they cost a check each.
"""
from typing import Callable, Dict, Optional, Sequence

import torch

from ..data.augment import augment_batch
from ..data.video_wire import decode_video_wire
from ..parallel.mesh import Mesh, use_mesh
from ..parallel.tensor import sync_replicated_
from ..utils.profiling import annotate
from .losses import cross_entropy, total_loss
from .optim import AdamWChain
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
                    missing_modality_rate: float = 0.0,
                    mesh: Optional[Mesh] = None) -> Callable:
    """(state, batch) → (state, metrics) over ``model`` (on its device) and
    ``optimizer`` (made over the model's parameters). ``missing_modality_rate``
    > 0 zeroes each modality of the whole batch with that probability, the
    robustness trainer's scenario draw. ``mesh``: the data-parallel mesh the
    step runs under (None: one process, the whole batch)."""
    del config  # the JAX step reads only the compute dtype from it; the model holds it
    compute_dtype = model.dtype

    def step(state: TrainState, batch: Dict):
        with use_mesh(mesh), annotate("smm.train_step"):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict):
        with annotate("smm.forward"):
            loss, parts = _forward(state, batch)
        with annotate("smm.backward"):
            grads = _backward(loss, optimizer, mesh)
            parts = {k: v.detach() for k, v in parts.items()}
            if mesh is not None:
                mesh.all_reduce_mean_(parts.values())
        with annotate("smm.optimizer"):
            parts["grad_norm"] = optimizer.update(grads)
        return TrainState(step=state.step + 1, generator=state.generator), parts

    def _forward(state: TrainState, batch: Dict):
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
        return total_loss(outputs, batch["emotion"], label_smoothing=0.1, logits_key=logits_key)

    return step


def _backward(loss: torch.Tensor, optimizer: AdamWChain, mesh: Optional[Mesh] = None) -> list:
    """The gradients of ``loss`` for the optimizer's parameters (None where
    none reaches one; the same on every rank, whose graphs are the same),
    averaged over the mesh's data group, the replicated parameters' the
    same over its model group, leaving no ``.grad`` behind."""
    for p in optimizer.params:
        p.grad = None
    loss.backward()
    grads = [p.grad for p in optimizer.params]
    for p in optimizer.params:
        p.grad = None
    if mesh is not None:
        mesh.all_reduce_mean_(grads)
        sync_replicated_(grads, optimizer.params, mesh)
    return grads


def make_fewshot_step(model, optimizer: AdamWChain, n_way: int, n_shot: int) -> Callable:
    """(state, support, query) → (state, loss) for a ``FewShotModel``: one
    episode in train mode, its dropouts drawn from a generator split from
    the state's. The loss is cross-entropy over the prototype
    probabilities, not logits, without label smoothing (the reference's
    quirk, kept as the JAX step keeps it). ``support`` holds n_way · n_shot
    clips ordered by class; both batches are dicts with text, audio, video
    and (query) emotion. The episode is whole on every process: it runs
    under no mesh, as the JAX few-shot trainer makes none."""

    def step(state: TrainState, support: Dict, query: Dict):
        with use_mesh(None):
            return _step(state, support, query)

    def _step(state: TrainState, support: Dict, query: Dict):
        device = next(model.parameters()).device
        (g_drop,) = _device_generators(state, device, 1)
        model.train()
        out = model(support, query, n_way, n_shot, gen=g_drop)
        loss = cross_entropy(out["predictions"], query["emotion"])
        optimizer.update(_backward(loss, optimizer))
        return TrainState(step=state.step + 1, generator=state.generator), loss.detach()

    return step


def make_eval_step(model, compute_loss: bool = True, logits_key: str = "emotion_logits",
                   missing_modalities: Optional[Sequence[str]] = None) -> Callable:
    """batch → outputs dict (logits, probs, predictions, mean features,
    late fusion's individual_logits [, loss]) in eval mode."""
    mm = tuple(missing_modalities) if missing_modalities else None

    @torch.no_grad()
    def step(batch: Dict) -> Dict:
        model.eval()
        outputs = model(batch["text"], batch["audio"], batch["video"], missing_modalities=mm)
        logits = outputs[logits_key]
        result = {
            "logits": logits,
            "probs": torch.softmax(logits, dim=-1),  # in the logits' dtype, as the JAX step
            "predictions": logits.argmax(dim=-1),
            "features": (outputs["text_features"] + outputs["audio_features"]
                         + outputs["video_features"]) / 3.0,
        }
        if "individual_logits" in outputs:
            result["individual_logits"] = outputs["individual_logits"]
        if compute_loss:
            result["loss"] = cross_entropy(logits, batch["emotion"], 0.1)
        return result

    return step
