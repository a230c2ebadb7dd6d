"""Process groups for the port's mesh tests: ``world`` spawned
processes on the CPU over gloo, joined through a ``file://`` store (no TCP
port: the suite runs under several xdist workers), one thread each, a
timeout on the group and on every child. Imports torch and the port only:
the children never import jax.

``Group(fn, world, tmp, **kwargs)`` starts the children at once; each runs
``fn(rank, world, tmp, **kwargs)`` inside the group (or, with
``own_group=True``, with ``torchrun``'s RANK/WORLD_SIZE/LOCAL_RANK set and
no group, which ``fn`` joins itself) and saves what it returns
(``torch.save``); ``Group.results()`` joins them and returns the results in
rank order, raising a child's traceback if one failed. The ``*_rank``
functions below are the children's bodies; their helpers build the tiny
port model and batches the parent builds too.
"""
import contextlib
import importlib.util
import multiprocessing
import os
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 60   # each collective
CHILD_TIMEOUT_S = 240  # each child, start to exit


class Group:
    def __init__(self, fn, world: int, tmp, own_group: bool = False, **kwargs):
        self.tmp = Path(tmp)
        self.tmp.mkdir(parents=True, exist_ok=True)
        self.name = fn.__name__
        ctx = multiprocessing.get_context("spawn")
        self.deadline = time.monotonic() + CHILD_TIMEOUT_S
        self.procs = [ctx.Process(target=_child,
                                  args=(fn, rank, world, str(self.tmp), own_group, kwargs),
                                  daemon=True) for rank in range(world)]
        for p in self.procs:
            p.start()

    def results(self):
        for p in self.procs:
            p.join(max(self.deadline - time.monotonic(), 0.0))
        hung = [rank for rank, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        errors = []
        for rank, p in enumerate(self.procs):
            err = self.tmp / f"{self.name}.{rank}.err"
            if err.exists():
                errors.append(f"rank {rank}:\n{err.read_text()}")
            elif p.exitcode != 0:
                errors.append(f"rank {rank}: exit code {p.exitcode}")
        if hung:
            errors.insert(0, f"ranks {hung} still running after {CHILD_TIMEOUT_S} s, killed")
        if errors:
            raise AssertionError(f"{self.name}: " + "\n".join(errors))
        return [torch.load(self.tmp / f"{self.name}.{rank}.pt", weights_only=False)
                for rank in range(len(self.procs))]


def store_url(tmp, fn) -> str:
    return f"file://{tmp}/{fn.__name__}.store"


def _child(fn, rank, world, tmp, own_group, kwargs):
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.modules["transformers"] = None  # no HF cache here: the hash tokenizer, no import
    name = f"{fn.__name__}.{rank}"
    try:
        if own_group:  # as torchrun starts a rank
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
        else:
            dist.init_process_group("gloo", init_method=store_url(tmp, fn), world_size=world,
                                    rank=rank, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = fn(rank, world, tmp, **kwargs)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, name + ".pt"))
    except BaseException:
        Path(tmp, name + ".err").write_text(traceback.format_exc())
        raise


# ------------------------------------------------------------------ helpers

TINY = dict(text_max_length=16, audio_max_length=3200, video_max_frames=4,
            video_frame_size=(32, 32), fusion_hidden_size=32, fusion_num_heads=4,
            graph_hidden_size=16, adapter_size=8, prompt_length=4, batch_size=2,
            encoder_preset="tiny")


def tiny_config(tmp, **kw):
    """The port's ModelConfig at the tiny sizes of tests/conftest.py."""
    from simple_multimodal_tpu_torch.config import ModelConfig

    tmp = Path(tmp)
    cfg = ModelConfig(**{**TINY, "data_path": str(tmp / "data"), "save_path": str(tmp / "ck"),
                         "log_path": str(tmp / "logs"), **kw})
    cfg.fusion_type = "hierarchical"
    return cfg


def eval_mode(model):
    """``model`` kept in eval mode under the train step's ``model.train()``:
    no dropout, gradients on."""
    model.eval()
    model.train = lambda mode=True: model
    return model


def tiny_model(cfg):
    from simple_multimodal_tpu_torch.models.multimodal_model import create_model

    return eval_mode(create_model(cfg, device="cpu", dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(0)))


def global_batch(B: int = 8, seed: int = 7):
    """A batch of B clips at the tiny sizes, from numpy with a seed."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, 16), np.int32)
    mask[1::2, 9:] = 0
    return {"text": {"input_ids": torch.from_numpy(rng.integers(1, 1000, (B, 16))),
                     "attention_mask": torch.from_numpy(mask)},
            "audio": torch.from_numpy(rng.standard_normal((B, 3200)).astype(np.float32)),
            "video": torch.from_numpy(rng.integers(0, 256, (B, 4, 32, 32, 3), np.uint8)),
            "emotion": torch.from_numpy(rng.integers(0, 7, B))}


def rows_of(batch, rows):
    return {k: ({kk: vv[rows] for kk, vv in v.items()} if isinstance(v, dict) else v[rows])
            for k, v in batch.items()}


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_two_steps(cfg, batch, mesh=None):
    """Two train steps of the tiny hierarchical model (contrastive loss on,
    dropout and augmentation off) on ``batch``, its parameters sharded over
    ``mesh``'s model axis: (losses, grad norms, the whole state_dict after
    them, the digest of this process's replicated parameters after each
    step)."""
    from simple_multimodal_tpu_torch.parallel.tensor import (gather_state_dict, placement,
                                                             shard_module)
    from simple_multimodal_tpu_torch.train.optim import make_optimizer
    from simple_multimodal_tpu_torch.train.state import TrainState
    from simple_multimodal_tpu_torch.train.steps import make_train_step

    model = tiny_model(cfg)
    if mesh is not None:
        shard_module(model, mesh)
    opt = make_optimizer(cfg, model, total_steps=10)
    step = make_train_step(model, opt, cfg, augment=False, compute_contrastive_loss=True,
                           mesh=mesh)
    state, losses, norms, digests = TrainState.create(3), [], [], []
    for _ in range(2):
        state, parts = step(state, batch)
        losses.append(float(parts["total_loss"]))
        norms.append(float(parts["grad_norm"]))
        digests.append(digest(p for p in model.parameters() if placement(p) is None))
    whole = gather_state_dict(model.state_dict(), mesh)
    return losses, norms, {k: v.clone() for k, v in whole.items()}, digests


def is_key_bias(name: str) -> bool:
    return name.endswith(("key.bias", "k_proj.bias", "in_proj_bias"))


def param_faults(got, want, travel):
    """Parameters off ``want`` beyond 1e-4 of their largest magnitude (and
    beyond 1e-4), key biases beyond ``travel`` (the k third of a packed
    in_proj_bias; its q and v thirds as any parameter)."""
    faults = []
    for name, w in want.items():
        g = got[name]
        if not w.is_floating_point():
            assert torch.equal(g, w), name
            continue
        pieces = [(name, g, w, is_key_bias(name))]
        if name.endswith("in_proj_bias"):
            E = w.shape[0] // 3
            pieces = [(f"{name}[{part}]", g[i * E:(i + 1) * E], w[i * E:(i + 1) * E],
                       part == "k") for i, part in enumerate("qkv")]
        for label, a, b, key_bias in pieces:
            err = float((a - b).abs().max())
            tol = 2 * travel if key_bias else min(1e-4 * float(b.abs().max()), 1e-4)
            if err > tol:
                faults.append((label, err, tol))
    return faults


def step_faults(got, want):
    """What keeps a run of ``train_two_steps`` on a mesh from the world-1
    one: loss and gradient norm beyond 1e-5 relative, ``param_faults``."""
    from simple_multimodal_tpu_torch.train.optim import make_schedule

    faults = []
    for what, a, b in (("loss", got[0], want[0]), ("grad_norm", got[1], want[1])):
        if not np.allclose(a, b, rtol=1e-5, atol=0):
            faults.append((what, a, b))
    schedule = make_schedule(tiny_config(".").learning_rate, 10)
    travel = sum(schedule(c) for c in range(2))  # the two steps' Σ lr
    return faults + param_faults(got[2], want[2], travel)


def load_cli():
    spec = importlib.util.spec_from_file_location("train_advanced_torch",
                                                  ROOT / "train_advanced_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def record_writes(rank: int, log: list):
    """Wrap the checkpoint writers the trainer and the CLI call so that each
    call is logged as (rank, path)."""
    from simple_multimodal_tpu_torch.train import checkpoint, trainer

    def wrap(fn):
        def recorded(path, *a, **kw):
            log.append((rank, str(path)))
            return fn(path, *a, **kw)
        return recorded

    save = wrap(checkpoint.save_checkpoint)
    checkpoint.save_checkpoint = trainer.save_checkpoint = save
    checkpoint.save_params = wrap(checkpoint.save_params)


# ------------------------------------------------------------ the children

def dp_step_rank(rank, world, tmp):
    """Two steps at world ``world`` on this rank's rows of the global batch
    of 8, with the contrastive term global, then with it rank-local."""
    from simple_multimodal_tpu_torch.models import fusion
    from simple_multimodal_tpu_torch.parallel.mesh import make_mesh

    cfg = tiny_config(tmp)
    mesh = make_mesh((world, 1), "cpu")
    batch = rows_of(global_batch(), mesh.rows(8))
    out = {"global": train_two_steps(cfg, batch, mesh)}
    gather = fusion.gather_rows
    fusion.gather_rows = lambda x: x  # each rank's own negatives only
    try:
        out["local"] = train_two_steps(cfg, batch, mesh)
    finally:
        fusion.gather_rows = gather
    return out


# the sample set of 2 clips an emotion has 9 train clips: one step an epoch,
# which keeps the JAX (2, 1) trainer to one compile of its step
TRAINER_BATCH = 10


def port_trainer(tmp, weights, data, world: int, resume_from=None, model_axis: int = 1):
    """The port's AdvancedTrainer at mesh (world / model_axis, model_axis), one epoch of batches of
    ``TRAINER_BATCH``, from ``weights`` on the sample set ``data``, as
    tests/test_torch_trainer.py's parity run: dropout off (eval mode), the
    clip norm above every gradient norm, the LSTM's bias_hh frozen."""
    from simple_multimodal_tpu_torch.data import dataset as pdataset
    from simple_multimodal_tpu_torch.models.multimodal_model import MultimodalEmotionModel
    from simple_multimodal_tpu_torch.train.trainer import AdvancedTrainer

    cfg = tiny_config(tmp, num_epochs=1, gradient_clip_norm=1e6, batch_size=TRAINER_BATCH,
                      mesh_shape=(world // model_axis, model_axis))
    for d in (cfg.save_path, cfg.log_path):
        Path(d).mkdir(parents=True, exist_ok=True)
    model = eval_mode(MultimodalEmotionModel(cfg))
    model.load_state_dict(torch.load(weights, weights_only=True))
    for name, p in model.named_parameters():
        if "bias_hh" in name:
            p.requires_grad_(False)
    loaders = {}
    for split in ("train", "val", "test"):
        ds = pdataset.get_dataset("sample", data, split, cfg)
        loaders[split] = pdataset.create_dataloader(ds, TRAINER_BATCH, shuffle=split == "train",
                                                    seed=0)
    return AdvancedTrainer(model, cfg, loaders["train"], loaders["val"], loaders["test"],
                           seed=0, resume_from=resume_from)


def state_of(trainer):
    """The trainer's whole state_dict (gathered over its mesh's model axis:
    every process calls it)."""
    from simple_multimodal_tpu_torch.parallel.tensor import gather_state_dict

    whole = gather_state_dict(trainer.model.state_dict(), trainer.mesh)
    return {k: v.clone() for k, v in whole.items()}


def trainer_rank(rank, world, tmp, weights, data, ck1):
    """One epoch of ``port_trainer`` at this world, a checkpoint ``ck2``
    after it, then a resume of the world-1 checkpoint ``ck1``."""
    writes = []
    record_writes(rank, writes)
    t = port_trainer(tmp, weights, data, world)
    t.train()
    val, _, preds, targets, _ = t.validate()
    t.save_checkpoint("ck2", 0, val)
    resumed = port_trainer(tmp, weights, data, world, resume_from=ck1)
    return {"train_losses": t.train_losses, "val_losses": t.val_losses,
            "lr_history": t.lr_history, "step": t.state.step, "state_dict": state_of(t),
            "val": val, "preds": list(preds), "targets": list(targets),
            "test": t.evaluate_test_set(), "writes": writes,
            "ck2": str(Path(t.config.save_path) / "ck2"),
            "resumed": (resumed.state.step, resumed.start_epoch, state_of(resumed))}


def cli_rank(rank, world, tmp, data, model_axis: int = 1):
    """``train_advanced_torch.main`` at ``--device cpu --mesh world/m,m``, tiny
    media sizes, started as torchrun starts a rank (``own_group``): main's
    ``initialize_distributed`` reads the rank and the world size from the
    environment and makes the gloo group, at a ``file://`` store here in
    place of torchrun's TCP one."""
    import functools

    from simple_multimodal_tpu_torch.parallel import mesh

    mesh.initialize_distributed = functools.partial(mesh.initialize_distributed,
                                                    store_url(tmp, cli_rank))
    cli = load_cli()
    cli.ModelConfig = lambda **kw: tiny_config(tmp, **kw)
    writes = []
    record_writes(rank, writes)
    mesh = f"{world // model_axis},{model_axis}"
    out = cli.main(["--device", "cpu", "--preset", "tiny", "--mesh", mesh,
                    "--fusion_type", "early", "--data_path", data,
                    "--save_path", str(Path(tmp) / "cli"), "--epochs", "1",
                    "--batch_size", "4"])
    t = out["trainer"]
    return {"path": out["path"], "step": t.state.step, "train_losses": t.train_losses,
            "val_f1": t.val_f1_scores, "writes": writes, "state_dict": state_of(t)}


# ------------------------------------------------------ tensor parallelism

FAULTS = ("gather_param_sums", "clip_norm_local")


@contextlib.contextmanager
def planted(fault: str):
    """A fault the tensor-parallel checks must see: ``gather_param_sums``
    sums the gathered weights' gradients over the model group in the
    backward (each is then m times the whole gradient); ``clip_norm_local``
    takes the clip's global norm over this process's shards alone."""
    from simple_multimodal_tpu_torch.parallel import tensor
    from simple_multimodal_tpu_torch.train import optim

    if fault == "gather_param_sums":
        owner, attr = tensor._GatherParam, "backward"

        def bad(ctx, g):
            mesh = ctx.mesh
            whole = tensor.model_sum(g, mesh)
            return tensor.split(whole, ctx.spec, mesh.model, mesh.model_index), None, None

        bad = staticmethod(bad)
    else:
        owner, attr = optim, "global_norm"
        local = optim.global_norm

        def bad(grads, params=None):
            return local(grads)

    saved = owner.__dict__[attr]
    setattr(owner, attr, bad)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def tp_logits(cfg, weights, batch, mesh):
    """The tiny model in eval mode on ``weights``, its parameters sharded over
    ``mesh``'s model axis: the logits of this rank's rows of ``batch``,
    gathered over the data group (the global batch's)."""
    from simple_multimodal_tpu_torch.models.multimodal_model import MultimodalEmotionModel
    from simple_multimodal_tpu_torch.parallel.tensor import shard_module

    model = MultimodalEmotionModel(cfg).eval()
    model.load_state_dict(torch.load(weights, weights_only=True))
    shard_module(model, mesh)
    rows = rows_of(batch, mesh.rows(len(batch["emotion"])))
    with torch.no_grad():
        out = model(rows["text"], rows["audio"], rows["video"])
    return mesh.gather(out["emotion_logits"])


def tp_rank(rank, world, tmp, model_axis, weights, data=None, ck1=None):
    """At mesh (world / model_axis, model_axis): the eval logits of the
    global batch on ``weights``; two train steps (``train_two_steps``) on
    this rank's rows, faithful and with each planted fault; with ``ck1`` (a
    world-1 trainer's checkpoint after its first epoch) the trainer resumed
    from it at this mesh, its second epoch and a checkpoint ``ck2``."""
    from simple_multimodal_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((world // model_axis, model_axis), "cpu")
    cfg = tiny_config(tmp)
    batch = global_batch()
    rows = rows_of(batch, mesh.rows(8))
    out = {"logits": tp_logits(cfg, weights, batch, mesh),
           "steps": train_two_steps(cfg, rows, mesh)}
    for fault in FAULTS:
        with planted(fault):
            out[fault] = train_two_steps(cfg, rows, mesh)
    if ck1:
        t = port_trainer(Path(tmp) / "resume", weights, data, world, resume_from=ck1,
                         model_axis=model_axis)
        out["resumed"] = (t.state.step, t.start_epoch, state_of(t))
        t.current_epoch = 1
        out["epoch2"] = t.train_epoch()
        t.save_checkpoint("ck2", 1, {})
        out["after"] = (t.state.step, state_of(t))
        out["ck2"] = str(Path(t.config.save_path) / "ck2")
    return out
