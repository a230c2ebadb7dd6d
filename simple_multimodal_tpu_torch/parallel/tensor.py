"""The mesh's ``model`` axis: tensor parallelism (port of
simple_multimodal_tpu/parallel/mesh.py:79-150, ``param_partition_spec`` and
``params_shardings``, and of what XLA's partitioner and the kernels'
``shard_map``s do with them under a (d, m) mesh).

Storage. ``shard_module`` replaces each parameter that the JAX rule shards
over ``model`` by this process's shard of it, in place, and tags it with its
``Sharded`` placement (the ``tp`` attribute). The state-dict names stay the
single-process ones: ``shard_state_dict`` cuts a whole state to a process's
shards and ``gather_state_dict`` stitches the shards back, so checkpoints
hold the whole state and resume under any mesh. The optimizer makes its
Adam moments like its parameters, so they are shards too.

Compute, as the JAX package runs under the mesh:

- a module reads a weight through ``weight``: a replicated one is cast to
  the compute dtype; a sharded one is cast and then gathered over the model
  group (``gather_param``). Every model process then computes the whole
  layer on its data shard's rows, the same work on each, as XLA gathers the
  weights that the kernels' ``shard_map``s take whole (attention_block,
  ffn_block, the MHAs, ViT's patch embedding, the biLSTM's input matmuls,
  the fusion). The cast is elementwise, so the gathered bits are those of
  the single-process run, at half the bytes in bf16;
- DeBERTa's attention splits its heads over the model group, as the JAX
  ``deberta_attention`` ``shard_map`` does: the q/k/v projections on their
  gathered weights give every head, this process keeps its own
  (``scatter_to_model``, whose backward gathers the heads' gradients), and
  the heads' outputs are gathered for the output projection
  (``gather_param``). Every product then computes, forward and backward,
  the bits one process computes. The Megatron layout (q/k/v from the
  shards, the output projection summed over the group) computes the same
  function, but its split sums round otherwise in bf16, and on an H100 a
  step's gradient norm then parted from one process's by more than the
  data axis's bf16 bound (PERF.md);
- DeBERTa's word embeddings are vocab-parallel: a masked lookup in this
  process's rows, then a sum over the group (``vocab_lookup``), the layout
  JAX's rule names (``mesh.py:95``), with no gather of the table.

Gradients. ``gather_param``'s backward keeps this process's slice of the
whole weight's gradient and sums nothing: the m processes of a data index
computed the same rows with the same whole weight, so each holds the whole
gradient already (a sum would multiply it by m). A replicated parameter
gets the same gradient on every model process in exact arithmetic: every
input it sees is the same there, the head split's included. On the card a
kernel that sums in no fixed order (cuDNN's convolution backwards) makes
those gradients part in their last bits, and the replicated parameters
would part with them, so ``sync_replicated_`` gives every model process
its group's first process's (``train/steps.py``, after the mean over the
data group). The global norm sums the shards' squares over the model group
(``train/optim.py::global_norm``).

The DeepSeek text tower (``models/deepseek.py``) has no rule here: a model
axis above 1 refuses it, naming its parameters (``refuse_model_axis``);
data parallelism runs it as any model. A dimension or head count that m
does not divide raises a ``ValueError`` naming it (the JAX kernels fall
back to their XLA paths there, ``ops/pallas/spmd.py:20-32``).
"""
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, _unflatten


@dataclasses.dataclass(frozen=True)
class Shard:
    """The dimension a tensor is split along over ``model``, in torch
    layout. With ``parts`` > 1 the dimension holds that many blocks, each
    split on its own: MHA's packed ``in_proj_weight`` [3E, E] is JAX's
    three column-sharded q/k/v kernels (``models/from_jax.py::_mha``)."""

    dim: int
    parts: int = 1


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A sharded parameter's placement: its ``Shard``, the mesh and its
    whole shape."""

    spec: Shard
    mesh: Mesh
    shape: Tuple[int, ...]


# JAX's markers (mesh.py:129-133) in the port's names: a Linear's parent
# module, or its (grandparent, parent) where the reference's name nests it
COLUMN = {"query", "key", "value", "query_proj", "key_proj", "value_proj", "q_proj", "k_proj",
          "v_proj", "intermediate_dense"}
COLUMN_PAIRS = {("intermediate", "dense"), ("ffn", "0")}
ROW = {"out_proj", "output_dense"}
ROW_PAIRS = {("output", "dense"), ("ffn", "3")}


def param_partition_spec(name: str, ndim: int) -> Optional[Shard]:
    """JAX ``param_partition_spec`` on the port's state-dict name of a
    parameter of ``ndim`` dimensions, transposed to torch layout: the
    ``Shard`` it is split by over ``model``, or None (replicated).

    - column-parallel (flax's output dimension, a torch ``Linear``'s dim 0):
      the attention q/k/v projections (MHA's packed ``in_proj_weight``
      third by third), the FFN up projections, ViT's patch-embedding conv
      [E, 3, p, p];
    - row-parallel (dim 1): the attention output projections, the FFN down
      projections, the biLSTM's ``weight_ih_l*`` [4H, in];
    - vocab-parallel: DeBERTa's ``word_embeddings`` by rows;
    - everything else replicated: biases, norms, ``weight_hh``,
      ``rel_embeddings``, the heads and the classifier.

    As the rule's code (not its docstring, which calls every fusion weight
    replicated) the markers also take the MulT blocks' and adaptive
    fusion's attention and FFN weights and the facial and temporal MHAs.
    """
    keys = name.split(".")
    leaf = keys[-1]
    parent = keys[-2] if len(keys) > 1 else ""
    pair = (keys[-3] if len(keys) > 2 else "", parent)
    if leaf == "in_proj_weight":
        return Shard(0, 3)
    if leaf.startswith("weight_ih_l"):
        return Shard(1)
    if leaf != "weight":
        return None
    if pair == ("patch_embeddings", "projection") and ndim == 4:
        return Shard(0)
    if parent == "word_embeddings":
        return Shard(0)
    if ndim != 2:
        return None
    if parent in COLUMN or pair in COLUMN_PAIRS:
        return Shard(0)
    if parent in ROW or pair in ROW_PAIRS:
        return Shard(1)
    return None


def _blocks(t: torch.Tensor, spec: Shard, m: int, name: str) -> torch.Tensor:
    """``t`` viewed with its split dimension as [parts, m, n / (parts·m)]."""
    n = t.shape[spec.dim]
    if n % (spec.parts * m):
        raise ValueError(f"{name}: dimension {spec.dim} of {tuple(t.shape)} does not split "
                         f"into {spec.parts} x {m} shards over the model axis of {m}")
    return t.unflatten(spec.dim, (spec.parts, m, n // (spec.parts * m)))


def split(t: torch.Tensor, spec: Shard, m: int, index: int, name: str = "tensor") -> torch.Tensor:
    """Shard ``index`` of ``m`` of the whole ``t`` (a view)."""
    return _blocks(t, spec, m, name).select(spec.dim + 1, index).flatten(spec.dim, spec.dim + 1)


def stitch(shards: List[torch.Tensor], spec: Shard) -> torch.Tensor:
    """The whole tensor from its m shards in model-index order."""
    d = spec.dim
    parts = [s.unflatten(d, (spec.parts, s.shape[d] // spec.parts)) for s in shards]
    return torch.stack(parts, d + 1).flatten(d, d + 2)


def _all_gather(shard: torch.Tensor, spec: Shard, mesh: Mesh) -> torch.Tensor:
    src = shard.contiguous()
    raw = src.view(torch.uint8)  # the bits, whatever the dtype, on any backend
    parts = [torch.empty_like(raw) for _ in range(mesh.model)]
    dist.all_gather(parts, raw, group=mesh.model_group)
    return stitch([p.view(src.dtype) for p in parts], spec)


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model group, in f32 at least (a new, contiguous
    tensor: NCCL takes no other)."""
    y = x.to(torch.promote_types(x.dtype, torch.float32), memory_format=torch.contiguous_format,
             copy=True)
    dist.all_reduce(y, group=mesh.model_group)
    return y.to(x.dtype)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _all_gather(shard, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return split(g, ctx.spec, mesh.model, mesh.model_index).contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return split(x, spec, mesh.model, mesh.model_index).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.spec, ctx.mesh), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return model_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_param(shard: torch.Tensor, spec: Shard, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model process's ``shard`` (all-gather
    over the model group): a weight, or DeBERTa's attention output by
    heads. The backward keeps this process's slice: every model process
    computes the same with the whole tensor, so each holds its whole
    gradient."""
    return _GatherParam.apply(shard, spec, mesh)


def scatter_to_model(x: torch.Tensor, spec: Shard, mesh: Mesh) -> torch.Tensor:
    """This process's shard of the whole ``x`` that every model process
    holds (the transpose of ``gather_param``): its slice forward; backward,
    every process's slice gradient gathered whole, so that what came before
    it gets the one-process gradient on every process."""
    return _ScatterToModel.apply(x, spec, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the model group forward, identity backward: the output of a
    product over a sharded contraction (the vocab-parallel lookup)."""
    return _ReduceFromModel.apply(x, mesh)


def placement(p: torch.Tensor) -> Optional[Sharded]:
    """A parameter's ``Sharded`` placement, None where it is whole."""
    return getattr(p, "tp", None)


def global_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """A parameter's whole shape (its own where it is not sharded)."""
    tp = placement(p)
    return tuple(p.shape) if tp is None else tp.shape


def weight(p: torch.Tensor, dtype) -> torch.Tensor:
    """The whole weight ``p`` in ``dtype``: a sharded one cast, then
    gathered over the model group."""
    w = p.to(dtype)
    tp = placement(p)
    return w if tp is None else gather_param(w, tp.spec, tp.mesh)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, dtype, mesh: Mesh) -> torch.Tensor:
    """Rows ``ids`` of a vocab-parallel table whose shard ``table`` holds
    rows [j·V/m, (j+1)·V/m) on model index j: each process looks up the ids
    in its rows (zeros elsewhere), then the group sums, which is exact."""
    rows = table.shape[0]
    local = ids - mesh.model_index * rows
    inside = (local >= 0) & (local < rows)
    emb = table.to(dtype)[local.clamp(0, rows - 1)]
    emb = torch.where(inside[..., None], emb, torch.zeros((), dtype=dtype, device=emb.device))
    return reduce_from_model(emb, mesh)


def sync_replicated_(grads: List[Optional[torch.Tensor]], params: List[torch.Tensor],
                     mesh: Optional[Mesh]) -> None:
    """The gradients (aligned with ``params``) of the replicated parameters
    set, in place, to those of the first process of this model group (one
    broadcast of their concatenation), so that the replicated parameters
    stay bit-identical over the group. Nothing without a model axis."""
    if mesh is None or mesh.model == 1:
        return
    ts = [g for g, p in zip(grads, params) if g is not None and placement(p) is None]
    if not ts:
        return
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, mesh.data_index * mesh.model, group=mesh.model_group)
        _unflatten(flat, ts)


def check_heads(m: int, heads: int, who: str) -> None:
    """Raise unless the model axis ``m`` divides ``who``'s attention heads."""
    if m < 1 or heads % m:
        raise ValueError(f"the model axis of {m} does not divide {who}'s {heads} attention "
                         f"heads, which the mesh splits over it")


def name_patterns(names) -> List[str]:
    """Parameter names with every numeric component as ``*``, in order, once each."""
    out = []
    for n in names:
        p = re.sub(r"(^|\.)\d+(?=\.|$)", r"\1*", n)
        if p not in out:
            out.append(p)
    return out


def refuse_model_axis(m: int, who: str, names) -> None:
    """Raise for a model axis m > 1 over a module that has no sharding rule,
    naming its parameters (``names``, with layer and expert indices as *)."""
    if m > 1:
        raise ValueError(f"{who}: no rule splits its parameters over a model axis "
                         f"({', '.join(name_patterns(names))}); the model axis of {m} refuses "
                         f"it: run it on a mesh of d,1")


def shard_module(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this process's shard of each parameter the rule shards, in
    place, tagged with its placement; nothing when the model axis is 1.
    Every module that splits heads over the axis (``split_heads_of``
    attribute: its head count) must have m divide them; a module marked
    ``refuses_model_axis`` (the DeepSeek text tower) raises."""
    if mesh.model == 1:
        return module
    for name, mod in module.named_modules():
        if getattr(mod, "refuses_model_axis", False):
            refuse_model_axis(mesh.model, name or type(mod).__name__,
                              [n for n, _ in mod.named_parameters()])
        heads = getattr(mod, "split_heads_of", None)
        if heads is not None:
            check_heads(mesh.model, heads, name or type(mod).__name__)
    with torch.no_grad():
        for name, p in module.named_parameters():
            spec = param_partition_spec(name, p.ndim)
            if spec is None:
                continue
            shape = tuple(p.shape)
            p.data = split(p.data, spec, mesh.model, mesh.model_index, name).contiguous()
            p.tp = Sharded(spec, mesh, shape)
    return module


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """This process's shards of a whole state (``sd`` itself without a model
    axis)."""
    if mesh is None or mesh.model == 1:
        return sd
    out = {}
    for name, t in sd.items():
        spec = param_partition_spec(name, t.ndim)
        out[name] = t if spec is None else split(
            t, spec, mesh.model, mesh.model_index, name).contiguous()
    return out


def gather_state_dict(sd: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The whole state from every model process's shards of it, on every
    process (``sd`` itself without a model axis). A collective over the
    model group: every process calls it with the same names."""
    if mesh is None or mesh.model == 1:
        return sd
    out = {}
    for name, t in sd.items():
        spec = param_partition_spec(name, t.ndim)
        out[name] = t if spec is None else _all_gather(t.detach(), spec, mesh)
    return out
