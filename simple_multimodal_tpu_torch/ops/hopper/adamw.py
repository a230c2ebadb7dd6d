"""AdamW over one optimizer's f32 leaves on the card, in two launches:
``foreach_sumsq`` (each gradient's norm, from per-chunk sums of squares
folded per leaf in a fixed order) and ``foreach_adamw`` (clip, moments,
bias correction, weight decay, backbone scale and update in one pass over
every element, p, m and v written in place).

Replaces no TPU kernel: the JAX package leaves its optax chain to XLA
(``simple_multimodal_tpu/train/optim.py``). The plain version is the chain
of ``torch._foreach_*`` passes in ``train/optim.py::AdamWChain``, which runs
for CPU tensors; ``AdamWChain`` runs these kernels for CUDA ones. Bounds
and design are noted in ``csrc/adamw.cu``.

The tables (``AdamWTables``) are built once with the optimizer: the chunk
table over every leaf, the pointers to the parameters and both moments, the
backbone flags. The gradients are new tensors after every backward, so
their pointer table is uploaded each step (``AdamWTables.grad_table``)
from a fresh pinned buffer, which the caching host allocator keeps until
its copy has run. Every leaf must be a contiguous float32 tensor on the
parameters' device: anything else raises (there is no fallback).
"""
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

CHUNK = 1 << 16  # elements a chunk (a multiple of 4: chunks of an aligned leaf stay aligned)


def chunk_table(numels: Sequence[int], chunk: int = CHUNK) -> Tuple[List[int], List[int]]:
    """(chunk_leaf, chunk_begin) over leaves of ``numels`` elements: leaf i
    owns chunks chunk_begin[i] .. chunk_begin[i + 1] − 1, ceil(numel /
    chunk) of them, and chunk c covers its leaf's elements from (c −
    chunk_begin[leaf]) · chunk, the last one the remainder."""
    begin = [0]
    for n in numels:
        begin.append(begin[-1] + -(-n // chunk))
    leaf = [i for i in range(len(numels)) for _ in range(begin[i + 1] - begin[i])]
    return leaf, begin


def check_leaf(kind: str, i: int, t: torch.Tensor, device: torch.device, numel: int) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``numel``
    elements on ``device``."""
    if t.dtype != torch.float32:
        raise TypeError(f"foreach_adamw: {kind} {i} is {t.dtype}; the kernels take float32")
    if t.device != device:
        raise ValueError(f"foreach_adamw: {kind} {i} is on {t.device}, the parameters on "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"foreach_adamw: {kind} {i} is not contiguous")
    if t.numel() != numel:
        raise ValueError(f"foreach_adamw: {kind} {i} has {t.numel()} elements, its parameter "
                         f"{numel}")


class AdamWTables:
    """The tables of one optimizer's leaves on their device, built once:
    ``params``, ``mu`` and ``nu`` aligned lists of contiguous float32
    tensors, ``backbone`` a flag a leaf (its update × the backbone scale)."""

    def __init__(self, params: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor], backbone: Sequence[bool]):
        if not len(params) == len(mu) == len(nu) == len(backbone):
            raise ValueError("foreach_adamw: params, mu, nu and backbone must be aligned")
        self.device = params[0].device
        self.numels = [p.numel() for p in params]
        for kind, leaves in (("parameter", params), ("mu", mu), ("nu", nu)):
            for i, (t, n) in enumerate(zip(leaves, self.numels)):
                check_leaf(kind, i, t, self.device, n)
        self.chunk = CHUNK
        self.chunk_leaf, self.chunk_begin = chunk_table(self.numels)
        self.n_leaves, self.n_chunks = len(self.numels), len(self.chunk_leaf)
        self.elements = sum(self.numels)
        self.leaves = (list(params), list(mu), list(nu))  # the storage the pointers address
        self.param_ptrs = [p.data_ptr() for p in params]

        def upload(xs, dtype):
            return torch.tensor(xs, dtype=dtype).to(self.device)

        self.pointers = upload([t.data_ptr() for ts in self.leaves for t in ts], torch.int64)
        self.numel = upload(self.numels, torch.int64)
        self.backbone = upload([int(bool(b)) for b in backbone], torch.int32)
        self.chunk_leaf_t = upload(self.chunk_leaf, torch.int32)
        self.chunk_begin_t = upload(self.chunk_begin, torch.int32)
        self.partial = torch.empty(max(self.n_chunks, 1), dtype=torch.float32,
                                   device=self.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)

    def grad_pointers(self, grads: Sequence[Optional[torch.Tensor]]) -> List[int]:
        """The gradients' pointers (0 for None), after checking each
        gradient against its leaf and each parameter's storage against the
        table."""
        if len(grads) != self.n_leaves:
            raise ValueError(f"foreach_adamw: {len(grads)} gradients for {self.n_leaves} leaves")
        ptrs, dev, f32 = [], self.device, torch.float32
        for i, (g, p, n, at) in enumerate(zip(grads, self.leaves[0], self.numels,
                                              self.param_ptrs)):
            if p.data_ptr() != at:
                raise RuntimeError(f"foreach_adamw: parameter {i} was given new storage after "
                                   f"the optimizer was built")
            if g is None:
                ptrs.append(0)
                continue
            # the checks inline (a step passes ~10^3 gradients); check_leaf says what failed
            if g.dtype is not f32 or g.device != dev or not g.is_contiguous() or g.numel() != n:
                check_leaf("gradient", i, g, dev, n)
            ptrs.append(g.data_ptr())
        return ptrs

    def grad_table(self, grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """``grad_pointers`` as an int64 tensor [n] on the device, copied
        from a fresh pinned buffer without waiting for the device."""
        return torch.tensor(self.grad_pointers(grads), dtype=torch.int64,
                            pin_memory=True).to(self.device, non_blocking=True)


def foreach_sumsq(tables: AdamWTables, grads: torch.Tensor) -> torch.Tensor:
    """The norms [n] f32 of the gradients in ``grads`` (``grad_table``'s
    pointers; a null one reads as zero): one launch."""
    lib = _build.library()
    norms = torch.empty(tables.n_leaves, dtype=torch.float32, device=tables.device)
    p = _build.ptr
    err = lib.smm_foreach_sumsq(p(grads), p(tables.numel), p(tables.chunk_leaf_t),
                                p(tables.chunk_begin_t), tables.n_leaves, tables.n_chunks,
                                tables.chunk, p(tables.partial), p(tables.ticket), p(norms),
                                _build.stream_ptr(norms))
    _build.check(lib, err, "foreach_sumsq")
    foreach_sumsq.launches += 1
    return norms


def foreach_adamw(tables: AdamWTables, grads: torch.Tensor, norm: torch.Tensor, *,
                  clip: float, lr: float, b1: float, b2: float, count: int, eps: float,
                  weight_decay: float, backbone_scale: float) -> None:
    """One AdamW step of the tables' leaves in place, as the chain takes it:
    the gradients × (1 if ``norm`` < ``clip`` else clip / norm), the moments,
    the bias corrections of step ``count`` (from 1), + weight_decay · p,
    × ``backbone_scale`` on the backbone leaves, p −= lr · update. ``norm``
    is the global norm, a float32 scalar on the device: one launch."""
    if norm.dtype != torch.float32 or norm.numel() != 1 or norm.device != tables.device:
        raise ValueError("foreach_adamw: the norm must be one float32 on the leaves' device")
    lib = _build.library()
    p = _build.ptr
    ptrs, n = tables.pointers, tables.n_leaves
    err = lib.smm_foreach_adamw(
        p(grads), p(ptrs), p(ptrs) + 8 * n, p(ptrs) + 16 * n, p(tables.backbone),
        p(tables.numel), p(tables.chunk_leaf_t), p(tables.chunk_begin_t), tables.n_chunks,
        tables.chunk, p(norm), clip, lr, b1, b2, 1.0 - b1, 1.0 - b2, 1.0 - b1 ** count,
        1.0 - b2 ** count, eps, weight_decay, backbone_scale, _build.stream_ptr(norm))
    _build.check(lib, err, "foreach_adamw")
    foreach_adamw.launches += 1


foreach_sumsq.launches = 0
foreach_adamw.launches = 0
