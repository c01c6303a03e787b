"""Input pipeline: host -> device prefetch and streaming shards (the JAX
package's ``data/pipeline.py``).

The north star (BASELINE.json) calls for pretraining over ~850k records
(CinC21 + MIMIC-IV-ECG) that do not fit device memory: an input pipeline
that overlaps host reads and the H2D copy with device compute.  (The
reference's pipeline is the opposite extreme: one HDF5 row read per
``__getitem__`` with zero workers -- dataset.py:93, ptb_dataset.py:87.)

Two layers:
  * ``prefetch_to_device``: wraps any host batch iterator and keeps ``depth``
    batches in flight.  On a GPU each array leaf is copied into pinned host
    memory and sent with ``non_blocking=True`` on a side CUDA stream; the
    consumer's stream waits on the copy's event and the tensor is recorded
    on it (``record_stream``), so the copy of batch t+1 overlaps the compute
    of batch t and a tensor is never reused before the consumer has read it.
    Leaves keep their dtype (int16 stays int16 on the wire); non-array
    leaves (the corpus index of a ``MixedRecordStream`` item) pass through.
    On the CPU it is a plain pass-through.
  * ``ShardedRecordStream`` / ``MixedRecordStream``: epoch-shuffled streaming
    over on-disk shards (HDF5 'data' datasets), one shard in host RAM at a
    time, read by a background thread, and a seeded weighted mixture of
    corpora.  The numpy draws are JAX's, in JAX's order, so batch order,
    shard order and the mixture's choices equal the JAX package's for a
    seed.  Stopping early (``itertools.islice``) stops the shard thread.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..runtime import default_device


def _tree_map(fn, x):
    """``fn`` on every leaf of ``x`` (an array, or a tuple such as a
    ``(corpus, batch)`` or ``(signals, labels)`` item)."""
    if isinstance(x, tuple):
        return tuple(_tree_map(fn, v) for v in x)
    return fn(x)


class DevicePrefetcher:
    """``prefetch_to_device`` on a GPU: an iterator over ``iterator``'s items
    with every array leaf on ``device``.  Counts what it sent: ``batches``,
    ``h2d_bytes``, and ``all_pinned`` (every host leaf was copied from
    pinned memory, so the copies were asynchronous)."""

    def __init__(self, iterator, depth: int, device: torch.device):
        self._it = iter(iterator)
        self.depth = max(1, depth)
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._buf = collections.deque()
        self.batches = 0
        self.h2d_bytes = 0
        self.all_pinned = True

    def _put(self, x):
        if not hasattr(x, 'shape'):
            return x
        host = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        if not host.is_pinned():
            host = host.pin_memory()
        self.all_pinned &= host.is_pinned()
        self.h2d_bytes += host.numel() * host.element_size()
        with torch.cuda.stream(self.stream):
            return host.to(self.device, non_blocking=True)

    def _fill(self) -> None:
        while len(self._buf) < self.depth:
            try:
                item = next(self._it)
            except StopIteration:
                return
            moved = _tree_map(self._put, item)
            done = torch.cuda.Event()
            done.record(self.stream)
            self._buf.append((moved, done))
            self.batches += 1

    def __iter__(self):
        return self

    def __next__(self):
        self._fill()
        if not self._buf:
            raise StopIteration
        moved, done = self._buf.popleft()
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        _tree_map(lambda t: t.record_stream(consumer) if isinstance(t, torch.Tensor) else None,
                  moved)
        return moved


def prefetch_to_device(iterator: Iterator, depth: int = 2, sharding=None,
                       device: Optional[Union[str, torch.device]] = None) -> Iterator:
    """Keep ``depth`` device-resident batches in flight ahead of the consumer
    (``device``: default the GPU; on the CPU the items pass through as they
    are).  ``sharding``: a ``parallel.Mesh``, whose rank keeps and moves only
    its rows of each batch (``process_local_batch_slice`` over 'data'; a
    ``(corpus, batch)`` item keeps its corpus index), onto the mesh's device
    unless ``device`` says otherwise."""
    if sharding is not None:
        from ..parallel.distributed import process_local_batch_slice
        from ..parallel.mesh import Mesh
        if not isinstance(sharding, Mesh):
            raise TypeError(f'sharding must be a parallel.Mesh, got {type(sharding).__name__}')
        device = sharding.device if device is None else device

        def rows(x):   # an array's rows; a corpus index passes
            if getattr(x, 'ndim', 0):
                return x[process_local_batch_slice(x.shape[0], sharding)]
            return x
        iterator = (_tree_map(rows, item) for item in iterator)
    dev = default_device(device)
    if dev.type != 'cuda':
        return iter(iterator)
    return DevicePrefetcher(iterator, depth, dev)


class ShardedRecordStream:
    """Stream (B, C, L) batches from a list of HDF5 shards.

    A background thread reads shard t+1 from disk while shard t is consumed
    (the host-side half of double buffering; the device half is
    ``prefetch_to_device``).  Shard order reshuffles every epoch.
    """

    def __init__(self, shard_paths: Sequence[str], batch_size: int,
                 seed: int = 77, dataset: str = 'data', drop_last: bool = True,
                 loop: bool = False, dtype=np.float32):
        """``dtype=None`` keeps the stored dtype -- e.g. int16 ADC-count shards
        transferred raw and converted on the device (train_stream wire_scale)."""
        if not shard_paths:
            raise ValueError('ShardedRecordStream needs at least one shard')
        self.paths = list(shard_paths)
        self.batch_size = batch_size
        self.dataset = dataset
        self.drop_last = drop_last
        self.loop = loop
        self.dtype = dtype
        self.rng = np.random.default_rng(seed)

    def _load_shard(self, path: str) -> np.ndarray:
        import h5py
        with h5py.File(path, 'r') as f:
            arr = np.asarray(f[self.dataset])
            return arr if self.dtype is None else arr.astype(self.dtype)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            order = self.rng.permutation(len(self.paths))
            q: 'queue.Queue' = queue.Queue(maxsize=1)
            stop = threading.Event()

            def put(x) -> bool:
                while not stop.is_set():
                    try:
                        q.put(x, timeout=0.1)
                        return True
                    except queue.Full:
                        pass
                return False

            def producer(order=order):
                try:
                    for si in order:
                        if not put(self._load_shard(self.paths[si])):
                            return
                except Exception as e:     # re-raised by the consumer
                    put(e)
                    return
                put(None)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    shard = q.get()
                    if shard is None:
                        break
                    if isinstance(shard, Exception):
                        raise shard
                    idx = self.rng.permutation(shard.shape[0])
                    stop_at = ((len(idx) // self.batch_size) * self.batch_size
                               if self.drop_last else len(idx))
                    for i in range(0, stop_at, self.batch_size):
                        take = idx[i:i + self.batch_size]
                        if take.size < self.batch_size and self.drop_last:
                            break
                        yield shard[take]
            finally:
                stop.set()
                t.join()
            if not self.loop:
                return


class MixedRecordStream:
    """Weighted mixture over N corpora of shards (BASELINE config 5: e.g.
    CinC21 + MIMIC-IV-ECG pretraining).

    Each corpus is its own :class:`ShardedRecordStream` (looping,
    ``stream_cls``); every draw picks corpus ``i`` with probability
    ``weights[i]`` and yields ``(i, batch)`` -- whole batches stay
    single-corpus because corpora may differ in native rate, record length
    and wire scale, so each needs its own step (``MaeTrainer.train_stream``
    maps the index to it).

    Deterministic: the corpus choice sequence is a seeded stream independent
    of the per-corpus shard/record shuffles, so a killed run resumed via
    ``itertools.islice`` replays bit-identically.
    """

    stream_cls = ShardedRecordStream

    def __init__(self, corpora: Sequence[Sequence[str]], batch_size: int,
                 weights: Optional[Sequence[float]] = None, seed: int = 77,
                 dataset: str = 'data', dtype=None):
        """``corpora``: one shard-path list per corpus.  ``dtype=None`` keeps
        each shard's stored dtype (int16 wire passes through raw)."""
        if not corpora or not all(len(c) for c in corpora):
            raise ValueError('MixedRecordStream needs corpora of at least one shard each')
        w = np.asarray([1.0] * len(corpora) if weights is None else weights, np.float64)
        if w.shape != (len(corpora),) or not (w > 0).all():
            raise ValueError(f'weights {w} must be {len(corpora)} positive numbers')
        self.weights = w / w.sum()
        # child seeds decorrelated from each other and from the mix choices
        self.streams = [
            self.stream_cls(paths, batch_size, seed=seed + 1000 * (i + 1),
                            dataset=dataset, loop=True, dtype=dtype)
            for i, paths in enumerate(corpora)]
        self.seed = seed

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        its = [iter(s) for s in self.streams]
        rng = np.random.default_rng(self.seed)
        try:
            while True:
                i = int(rng.choice(len(its), p=self.weights))
                yield i, next(its[i])
        finally:
            for it in its:
                it.close()


def device_batches(signals: np.ndarray, labels: Optional[np.ndarray],
                   batch_size: int, rng: np.random.Generator,
                   sharding=None, depth: int = 2, drop_last: bool = True,
                   device: Optional[Union[str, torch.device]] = None) -> Iterator[Any]:
    """Shuffled minibatches from host arrays, prefetched to ``device``."""
    n = signals.shape[0]
    idx = rng.permutation(n)
    stop = (n // batch_size) * batch_size if drop_last else n

    def gen():
        for i in range(0, stop, batch_size):
            take = idx[i:i + batch_size]
            if labels is None:
                yield signals[take]
            else:
                yield signals[take], labels[take]

    return prefetch_to_device(gen(), depth=depth, sharding=sharding, device=device)
