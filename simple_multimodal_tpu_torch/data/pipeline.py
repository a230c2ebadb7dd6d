"""Host→device batch feeding (port of simple_multimodal_tpu/data/pipeline.py).

``prefetch_to_device`` keeps ``size`` batches in flight: a producer thread
decodes and collates on the host while the consumer's steps run, pins each
array (``Tensor.pin_memory``) and copies it to the card with
``non_blocking=True`` on a side ``torch.cuda.Stream``, one per prefetcher,
then records an event there. The consumer makes its current stream wait on
that event before it hands the batch out, and calls ``record_stream`` on
every tensor so the caching allocator reuses no buffer early. A producer's
exception is raised in the consumer. On the CPU it only turns the numpy
arrays into tensors.

``DeviceCachedLoader`` keeps a whole (small) data set on the card: the
loader's batches are copied once, and each epoch gathers its rows on the
device in the order of ``default_rng(seed + epoch).permutation``, as the
JAX loader does.

``DistributedLoader`` feeds one process of a data-parallel mesh: every
process iterates the same global batches and keeps its rows of each array
(JAX ``DistributedLoader``); ``DeviceCachedLoader`` given a mesh gathers
only those rows on the device.

Host-only fields (``text_raw``, ``sample_ids``) stay on the host, whole:
they name the global batch's rows.
"""
import queue as queue_mod
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

HOST_FIELDS = ("text_raw", "sample_ids")
_SENTINEL = object()


def _map_arrays(batch: Dict, fn) -> Dict:
    """``fn`` on every array of a collated batch (nested one level for the
    text dict); host-only fields pass through."""
    out = {}
    for k, v in batch.items():
        if k in HOST_FIELDS:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = {kk: fn(vv) for kk, vv in v.items()}
        else:
            out[k] = fn(v)
    return out


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def to_device(batch: Dict, device) -> Dict:
    """A collated batch's arrays as tensors on ``device`` (synchronous)."""
    return _map_arrays(batch, lambda x: _tensor(x).to(device))


def prefetch_to_device(iterator: Iterable, size: int = 2, device="cuda") -> Iterator[Dict]:
    """Yield batches with their arrays on ``device``, the next ``size`` ones
    decoded, collated and (on the card) copied ahead by a producer thread."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:  # the producer thread sets the device by index
        device = torch.device("cuda", torch.cuda.current_device())
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(size, 1))
    stop = threading.Event()
    stream = torch.cuda.Stream(device) if cuda else None

    def put(item) -> bool:
        """Queue ``item`` unless the consumer has stopped; False once it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            if cuda:
                torch.cuda.set_device(device)
            for batch in iterator:
                if cuda:
                    host = _map_arrays(batch, lambda x: _tensor(x).pin_memory())
                    with torch.cuda.stream(stream):
                        dev = _map_arrays(host, lambda t: t.to(device, non_blocking=True))
                        done = torch.cuda.Event()
                        done.record(stream)
                    item = (dev, done)
                else:
                    item = (_map_arrays(batch, _tensor), None)
                if not put(item):
                    return
        except BaseException as e:  # raised again in the consumer
            put(e)
            return
        put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            batch, done = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                _map_arrays(batch, lambda t: t.record_stream(current))
            yield batch
    finally:
        stop.set()
        thread.join(timeout=5.0)


class DeviceCachedLoader:
    """Keeps the whole data set on the card across epochs: the loader's
    batches (one epoch, wrap-padded to a uniform size) are copied once;
    each epoch draws a fresh sample→batch assignment by a row gather on the
    device, with ``default_rng(seed + epoch)`` as the JAX loader. Under a
    data-parallel ``mesh`` every rank caches the whole (small) set, draws the
    same permutation and gathers only its rows of each global batch."""

    def __init__(self, loader, device="cuda", seed: int = 0, mesh=None):
        self._seed = seed
        self._mesh = mesh
        batches = list(loader)
        if not batches:
            raise ValueError("DeviceCachedLoader needs a non-empty loader")
        self.batch_size = int(np.asarray(batches[0]["emotion"]).shape[0])
        self._num_batches = len(batches)
        sizes = [int(np.asarray(b["emotion"]).shape[0]) for b in batches]
        if any(sz != self.batch_size for sz in sizes):
            raise ValueError(
                f"DeviceCachedLoader needs uniform batch sizes, got {sizes}; "
                "use a wrap-padding loader (create_dataloader does this).")
        self._host = {k: [v for b in batches for v in b[k]] for k in HOST_FIELDS
                      if k in batches[0]}
        stacked = {}
        for k, v in batches[0].items():
            if k in HOST_FIELDS:
                continue
            if isinstance(v, dict):
                stacked[k] = {kk: np.concatenate([b[k][kk] for b in batches]) for kk in v}
            else:
                stacked[k] = np.concatenate([np.asarray(b[k]) for b in batches])
        self._n = self.batch_size * self._num_batches
        self.device = torch.device(device)
        self._data = to_device(stacked, self.device)
        self.dataset = getattr(loader, "dataset", None)
        self._epoch = 0

    def __len__(self):
        return self._num_batches

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self._seed + self._epoch)
        perm = rng.permutation(self._n)
        self._epoch += 1
        order = torch.from_numpy(perm).to(self.device)
        local = slice(None) if self._mesh is None else self._mesh.rows(self.batch_size)
        for b in range(self._num_batches):
            rows = perm[b * self.batch_size:(b + 1) * self.batch_size]
            idx = order[b * self.batch_size:(b + 1) * self.batch_size][local]
            batch = _map_arrays(self._data, lambda x: x.index_select(0, idx))
            for k, vals in self._host.items():
                batch[k] = [vals[int(i)] for i in rows]
            yield batch


class DistributedLoader:
    """One process's share of a loader that yields global batches: each
    array cut to this rank's rows (``mesh.rows``: rows = B // d from
    rank · rows, JAX ``pipeline.py:186-193``; a batch that the data axis does
    not divide raises), the host fields kept whole. Every process builds the
    same global batches (same seed, same shuffle), so no process reads
    another's rows. Not ``DistributedSampler``: that would make the global
    batch ``batch_size × world`` and change the number of steps."""

    def __init__(self, loader, mesh):
        self._loader = loader
        self._mesh = mesh
        self.dataset = getattr(loader, "dataset", None)

    def __len__(self):
        return len(self._loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self._loader, "set_epoch"):
            self._loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self._loader:
            rows = self._mesh.rows(len(batch["emotion"]))
            yield _map_arrays(batch, lambda x: x[rows])


def estimate_batch_bytes(batch: Dict) -> int:
    """Bytes of a collated (numpy) batch's arrays."""
    total = 0
    for k, v in batch.items():
        if k not in HOST_FIELDS:
            total += sum(int(x.nbytes) for x in (v.values() if isinstance(v, dict) else (v,)))
    return total
