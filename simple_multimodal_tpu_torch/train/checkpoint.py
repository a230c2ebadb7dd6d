"""Checkpoints (port of simple_multimodal_tpu/train/checkpoint.py).

A checkpoint is a directory, as in the JAX package. It holds ``meta.json``
with the JAX keys (``epoch``, ``metrics``, ``opt_state_fingerprint``,
``config``) and one ``torch.save`` file, ``checkpoint.pt``, with the
model's ``state_dict``, the ``AdamWChain``'s moments ``mu`` and ``nu`` and
its ``count`` (which drives both the bias correction and the schedule),
the step count, the ``TrainState`` generator's state (every per-step
generator is split from it) and the config as JSON. Restoring all of them
makes the rest of a run repeat bit for bit. Files load with
``weights_only=True``.

The fingerprint hashes the optimizer's parameter names, whole shapes and
dtypes; a resume under another optimizer raises instead of pairing moments
with the wrong parameters.

Under a mesh with a model axis (``parallel/tensor.py``) a process holds
shards of the parameters and moments. A checkpoint still holds the whole
state under the single-process names: every process gathers it
(``gather_state_dict``, ``optimizer_state``) before rank 0 alone writes it,
and ``restore_checkpoint`` given the mesh cuts the whole state to this
process's shards, so a checkpoint resumes under any mesh.

The JAX package's orbax format and its scan-layout migration are not read
here: cross-loading with JAX checkpoints goes through
``models/from_jax.py`` and the JAX package's converter.
"""
import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional

import torch

from ..config import config_to_dict
from ..parallel.tensor import gather_state_dict, global_shape, placement, shard_state_dict

FILENAME = "checkpoint.pt"


def optimizer_fingerprint(optimizer) -> str:
    """Stable hash of the optimizer's parameters: names, whole shapes, dtypes."""
    desc = ";".join(f"{n}:{global_shape(p)}:{p.dtype}"
                    for n, p in zip(optimizer.names, optimizer.params))
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


@dataclasses.dataclass
class OptimizerState:
    """An optimizer's moments, whole, its count and its fingerprint."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int
    fingerprint: str


def optimizer_state(optimizer, mesh=None) -> OptimizerState:
    """The optimizer's state whole: under a model axis its moments' shards
    gathered over the model group, a collective that every process calls."""
    def whole(moments):
        sd = gather_state_dict(dict(zip(optimizer.names, moments)), mesh)
        return [sd[n] for n in optimizer.names]

    return OptimizerState(whole(optimizer.mu), whole(optimizer.nu), int(optimizer.count),
                          optimizer_fingerprint(optimizer))


def _whole(params, what: str) -> None:
    if any(placement(p) is not None for p in params):
        raise ValueError(f"{what} holds shards over a model axis: gather the state on every "
                         "process first (gather_state_dict, optimizer_state) and pass it")


def _cpu(tensors):
    return [t.detach().to("cpu", copy=True) for t in tensors]


def save_checkpoint(path: str, model=None, state=None, optimizer=None,
                    metrics: Optional[Dict] = None, epoch: Optional[int] = None,
                    config=None, state_dict: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write a training checkpoint directory: ``model``'s parameters (or an
    explicit ``state_dict``, e.g. a best-model snapshot or a gathered
    state), the optimizer's state when given (an optimizer, or its
    ``OptimizerState``), the state's step and generator when given. A model
    or optimizer holding shards is refused: pass their gathered state."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if state_dict is None:
        _whole(model.parameters(), "the model")
        state_dict = model.state_dict()
    if optimizer is not None and not isinstance(optimizer, OptimizerState):
        _whole(optimizer.params, "the optimizer")
        optimizer = optimizer_state(optimizer)
    payload: Dict[str, Any] = {
        "state_dict": {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()},
    }
    if optimizer is not None:
        payload["optimizer"] = {"mu": _cpu(optimizer.mu), "nu": _cpu(optimizer.nu),
                                "count": optimizer.count}
    if state is not None:
        payload["step"] = int(state.step)
        payload["generator"] = state.generator.get_state()
    if config is not None:
        payload["config"] = json.dumps(config_to_dict(config))
    tmp = os.path.join(path, FILENAME + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, FILENAME))
    meta = {
        "epoch": epoch,
        "metrics": {k: float(v) for k, v in (metrics or {}).items()},
    }
    if optimizer is not None:
        meta["opt_state_fingerprint"] = optimizer.fingerprint
    if config is not None:
        meta["config"] = config_to_dict(config)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def save_params(path: str, model) -> None:
    """Weights-only checkpoint directory (no meta, no optimizer) of a model
    or a (whole) state dict."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    if not isinstance(model, dict):
        _whole(model.parameters(), "the model")
    sd = model if isinstance(model, dict) else model.state_dict()
    torch.save({"state_dict": {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}},
               os.path.join(path, FILENAME))


def load_payload(path: str) -> Dict[str, Any]:
    """The ``torch.save`` payload of a checkpoint directory, on the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), FILENAME), map_location="cpu",
                      weights_only=True)


def restore_params(path: str) -> Dict[str, torch.Tensor]:
    """Just the state_dict (on the CPU) of a checkpoint directory."""
    return load_payload(path)["state_dict"]


def read_meta(path: str) -> Dict[str, Any]:
    meta_path = os.path.join(os.path.abspath(path), "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def restore_checkpoint(path: str, model=None, optimizer=None, state=None,
                       mesh=None) -> Dict[str, Any]:
    """Restore a checkpoint directory into the live objects given: the
    parameters into ``model``, the moments and count into ``optimizer``
    (after the fingerprint check), the step and the generator into
    ``state``; under ``mesh``'s model axis, this process's shards of the
    parameters and moments. Returns the payload with ``meta``."""
    path = os.path.abspath(path)
    meta = read_meta(path)
    payload = load_payload(path)
    if optimizer is not None and payload.get("optimizer") is not None:
        saved_fp = meta.get("opt_state_fingerprint")
        live_fp = optimizer_fingerprint(optimizer)
        if saved_fp != live_fp:
            raise ValueError(
                f"Checkpoint at {path} was saved with a different optimizer "
                f"structure (fingerprint {saved_fp} != live {live_fp}); "
                "resume with the same optimizer configuration it was saved "
                "under, or restore params only.")
    if model is not None:
        model.load_state_dict(shard_state_dict(payload["state_dict"], mesh))
    if optimizer is not None and payload.get("optimizer") is not None:
        opt = payload["optimizer"]
        with torch.no_grad():
            for live, saved in ((optimizer.mu, opt["mu"]), (optimizer.nu, opt["nu"])):
                saved = shard_state_dict(dict(zip(optimizer.names, saved)), mesh)
                for t, name in zip(live, optimizer.names):
                    t.copy_(saved[name])
        optimizer.count = int(opt["count"])
    if state is not None:
        if payload.get("step") is not None:
            state.step = int(payload["step"])
        if payload.get("generator") is not None:
            state.generator.set_state(payload["generator"])
    payload["meta"] = meta
    return payload
