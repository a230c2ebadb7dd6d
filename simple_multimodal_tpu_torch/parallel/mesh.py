"""The (data, model) mesh over ``torch.distributed`` (port of
simple_multimodal_tpu/parallel/mesh.py:25-76).

One process per card, d·m processes in all, launched by ``torchrun``
(which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``)::

    torchrun --standalone --nproc_per_node=D*M train_advanced_torch.py --mesh D,M ...

Rank r sits at data index r // m and model index r % m, as JAX lays its
devices out (``np.array(devices).reshape(d, m)``). The ranks of one model
index form a data group, those of one data index a model group.

The JAX mesh's semantics are kept exactly, so that ``--mesh d,m`` on d·m
processes trains the same model, step for step, as ``--mesh 1,1`` on one:

- the loader yields the global batch and each process keeps its data
  shard's rows, ``[i·B/d, (i+1)·B/d)`` for data index i (``Mesh.rows``:
  JAX's ``batch_sharding`` and ``pipeline.py:186-193``); the m processes of
  a data index hold the same rows;
- the parameters start replicated: broadcast from rank 0 once
  (``replicated``); with m > 1 each process then keeps its shards of the
  parameters that JAX's ``param_partition_spec`` shards over ``model``
  (``parallel/tensor.py``); the gradients are averaged over the data group,
  so every process of a model index applies the same update;
- a random draw with a batch axis is made at the global batch size from a
  generator that is identical on every rank, and each rank keeps its data
  shard's rows (``draw_rows``), as ``jax.random`` draws under SPMD; the
  fused kernels' hash seeds are offset by ``data index · 1000003``, and
  DeBERTa's head-split attention's further by ``model index · 7919``
  (``kernel_seed_offset``), as the JAX kernels offset theirs by
  ``axis_index`` inside their ``shard_map``;
- the contrastive loss's in-batch negatives are the global batch
  (``gather_rows``, over the data group).

The backend is NCCL for CUDA tensors and gloo for CPU ones; gloo also
takes CUDA tensors (``initialize_distributed(backend="gloo")``), which puts
two ranks on one card, as NCCL does not.
"""
import contextlib
import dataclasses
import os
from datetime import timedelta
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.profiling import annotate

KERNEL_SEED_STRIDE = 1000003  # the JAX kernels' per-shard seed offset on the data axis
MODEL_SEED_STRIDE = 7919  # deberta_attention's further offset on the model axis
DEFAULT_TIMEOUT = timedelta(minutes=10)


def local_device(device="cuda") -> torch.device:
    """``device``; a CUDA device without an index is this process's card,
    ``cuda:LOCAL_RANK`` (0 without a launcher)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a (data, model) mesh: the axis sizes, its
    rank, its device and the process groups: ``group`` the world (None
    when no process group is up: then no collective runs), ``data_group``
    the ranks of this model index (the world when m = 1, None when d = 1 <
    m), ``model_group`` the ranks of this data index (None when m = 1).
    A collective over a group that is None is skipped."""

    data: int
    model: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Optional[object] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    # bytes all_reduce_mean_ has reduced (a counter: one mutable cell in the frozen mesh)
    reduced: list = dataclasses.field(default_factory=lambda: [0], compare=False, hash=False,
                                      repr=False)

    @property
    def reduced_bytes(self) -> int:
        """The bytes this mesh's ``all_reduce_mean_`` calls have reduced so far."""
        return self.reduced[0]

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def data_distributed(self) -> bool:
        return self.data_group is not None

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``: its data shard's."""
        if batch % self.data:
            raise ValueError(f"a global batch of {batch} does not split over the mesh's "
                             f"data axis of {self.data}")
        n = batch // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def all_reduce_mean_(self, tensors: Iterable[Optional[torch.Tensor]]) -> None:
        """Replace each tensor by its mean over the data group, in place,
        through one all-reduce of their concatenation (Nones are skipped:
        every rank must pass the same list). While a profiler records it is
        the span ``smm.allreduce``; ``reduced_bytes`` counts what it
        reduces."""
        ts = [t for t in tensors if t is not None]
        if not self.data_distributed or not ts:
            return
        with annotate("smm.allreduce"), torch.no_grad():
            flat = torch.cat([t.reshape(-1) for t in ts])
            self.reduced[0] += flat.numel() * flat.element_size()
            dist.all_reduce(flat, group=self.data_group)
            _unflatten(flat.div_(self.data), ts)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into every rank's ``tensors``, one broadcast per dtype."""
        if not self.distributed:
            return
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for ts in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                dist.broadcast(flat, 0, group=self.group)
                _unflatten(flat, ts)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data shard's ``x`` concatenated along the first axis in
        data-index order (no gradient): [d·n, ...] from [n, ...]."""
        if not self.data_distributed:
            return x
        src = x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.data)]
        dist.all_gather(parts, src, group=self.data_group)
        return torch.cat(parts)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.group)

    def on_rank0(self, write: Callable[[], object]) -> None:
        """Run ``write`` on rank 0 alone; the other ranks wait at a barrier
        until it is done (checkpoints, plots, reports)."""
        if self.rank == 0:
            write()
        self.barrier()


def _unflatten(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    """Copy the consecutive pieces of ``flat`` back into ``tensors``."""
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


_CURRENT: Optional[Mesh] = None


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    """Register the ambient mesh, which the random draws, the kernel seeds
    and the contrastive loss read (JAX: the Pallas kernels' ``shard_map``).
    ``None`` means one process and the whole batch."""
    global _CURRENT
    _CURRENT = mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """``mesh`` as the ambient mesh inside the block, the previous one after."""
    prev = current_mesh()
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group; returns whether one is up. With no
    arguments it reads ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (and the
    rendezvous address, ``env://``) from ``torchrun``. A no-op for one
    process and when a group is already up (``--mode all`` builds several
    trainers). The backend is NCCL for ``cuda`` (on ``cuda:LOCAL_RANK``),
    gloo for ``cpu``, unless ``backend`` names one. ``coordinator_address``:
    ``host:port`` or an init URL (``tcp://``, ``file://``). A collective
    that exceeds DEFAULT_TIMEOUT fails the run."""
    if dist.is_initialized():
        return True
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = coordinator_address or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=DEFAULT_TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_axes(mesh_shape: Tuple[int, int] = (1, 1)) -> Tuple[int, int]:
    """The (data, model) sizes of ``mesh_shape`` for the processes that are
    up: ``data == -1`` fills with the world size over ``model``; otherwise
    data · model must equal the world size (one process a shard)."""
    d, m = (int(x) for x in mesh_shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if d == -1 and m >= 1 and world % m == 0:
        d = world // m
    if d < 1 or m < 1 or d * m != world:
        raise ValueError(f"mesh {tuple(mesh_shape)}: the mesh needs data x model processes "
                         f"but the world size is {world}; launch one process a shard "
                         f"(torchrun --nproc_per_node=<data x model> ... --mesh {d},{m})")
    return d, m


def _axis_groups(d: int, m: int, rank: int):
    """(data group, model group) of ``rank``. Every rank makes every group,
    in the same order (``new_group`` is collective): the data groups, one a
    model index, then the model groups, one a data index."""
    if m == 1:
        return dist.group.WORLD, None
    data = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)] if d > 1 else None
    model = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    return (data[rank % m] if data else None), model[rank // m]


def make_mesh(mesh_shape: Tuple[int, int] = (1, 1), device="cuda") -> Mesh:
    """The (data, model) mesh of this process (``mesh_axes``), registered as
    current."""
    d, m = mesh_axes(mesh_shape)
    up = dist.is_initialized()
    rank = dist.get_rank() if up else 0
    data_group, model_group = _axis_groups(d, m, rank) if up else (None, None)
    mesh = Mesh(data=d, model=m, rank=rank, device=local_device(device),
                group=dist.group.WORLD if up else None, data_group=data_group,
                model_group=model_group)
    set_current_mesh(mesh)
    return mesh


def process_index() -> int:
    """This process's rank, 0 without a process group (JAX
    ``process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def replicated(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (one broadcast per
    dtype, once, before training and before any sharding: rank 0's shards
    are not the others')."""
    if any(getattr(p, "tp", None) is not None for p in module.parameters()):
        raise ValueError("replicated: the module holds shards over a model axis; broadcast "
                         "it whole, before parallel/tensor.py::shard_module")
    mesh.broadcast_([t for t in module.state_dict().values()])
    return module


def draw_rows(draw: Callable, shape: Sequence[int], **kw) -> torch.Tensor:
    """``draw(shape, **kw)`` of a random tensor whose first axis is the batch
    (or batch-major, as [B·T, ...]): under a mesh with a data axis d > 1 it
    is drawn at d times that size from the (rank-identical) generator and
    this rank keeps its rows, so every rank's generator stays where the
    single-process run's is and no rank repeats another's draws."""
    mesh = current_mesh()
    if mesh is None or mesh.data == 1:
        return draw(tuple(shape), **kw)
    n = shape[0]
    full = draw((n * mesh.data,) + tuple(shape[1:]), **kw)
    i = mesh.data_index
    return full[i * n:(i + 1) * n]


def kernel_seed_offset(model_axis: bool = False) -> int:
    """What the fused kernels add to their hash seed on this rank: the JAX
    ``axis_index("data") · 1000003``, and with ``model_axis`` (the kernel
    that splits heads over ``model``: deberta_attention) also
    ``axis_index("model") · 7919``."""
    mesh = current_mesh()
    if mesh is None:
        return 0
    offset = mesh.data_index * KERNEL_SEED_STRIDE
    return offset + mesh.model_index * MODEL_SEED_STRIDE if model_axis else offset


class _GatherRows(torch.autograd.Function):
    """All data shards' rows, in data-index order; the backward sums the
    rows' cotangents over the data group and keeps this rank's. Every rank's
    loss holds the same global term of the gathered rows and the gradients
    are then averaged over the data group, so the summed cotangent is the
    one that, after averaging, gives the single-process gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.gather(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.data_group)
        return g[mesh.rows(g.shape[0])], None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``x`` [n, ...] → [d·n, ...] under the
    current mesh, with the gradient reaching the rank that owns each row;
    ``x`` itself without a process group."""
    mesh = current_mesh()
    if mesh is None or not mesh.data_distributed:
        return x
    return _GatherRows.apply(x, mesh)
