"""K train steps, or a whole epoch, per dispatch (``TrainConfig.steps_per_dispatch``
and ``TrainConfig.epoch_scan``).

Counterpart of the JAX ``Trainer``'s ``multi_step`` (K steps unrolled into one
jitted program) and ``epoch_step`` (a ``lax.scan`` of the step over the
epoch).  On the GPU one dispatch is one replay of a ``torch.cuda.CUDAGraph``
of the real step: the forward through kernel #2, the backward through #3 and
#4, the FusedAdamW tail (#5's norm and update launches), the EMA and the
non-finite counter, every kernel launched by the replay as the eager step
launches it.  ``torch.compile`` is not used.

What the host changes from step to step lives in a :class:`StepTape`, one
device buffer that the host fills once per dispatch with one pinned copy:
row k is step k's batch indices into the resident split, every dropout seed
the step takes (drawn ahead from the trainer's host generator, in the order
the per-step loop draws them: nothing else draws from it in between), and
its optimizer scalars [lr, bc1, bc2, -lr].  A step reads all of them from the
device (``Trainer._tape_step``): the flash kernels take the seed's address
(``seed_dev``), the hashed dropout sites hash the seed tensor, the AdamW
norm launch copies lr, bc1 and bc2 into its scalars and ``AdamChain`` reads
bc1, bc2 and -lr.  TimeOut and the Bernoulli masks draw from the trainer's
device generators, which are registered with the graph, so a replay
advances them as the eager steps would.  The updates are the per-step
loop's bit for bit: the same batches, seeds, masks, TimeOut draws, Adam
state, EMA and generator states afterwards.

  * ``steps_per_dispatch = K``: one graph of K consecutive steps, step k
    reading tape row k; the epoch's leftover steps (steps_per_epoch % K) run
    the ordinary single step;
  * ``epoch_scan``: one graph of one step that reads the tape row at a
    device cursor (``index_select`` into a row buffer) and bumps it, replayed
    steps_per_epoch times back to back with the epoch's tape uploaded once
    (the counterpart of ``lax.scan``'s single compiled body; a graph of the
    whole epoch would hold ~1,150 nodes a step).  The per-step losses and
    gradient norms stay in device buffers until the epoch ends.

The first dispatch of a ``train()`` runs the same steps eagerly through the
tape, on the stream the capture then uses: it builds the kernels, the AdamW
block table and the cuBLAS state, and its steps count.  A dispatch of
another number of steps (an epoch's leftover steps, one a dispatch) is
captured at its first call into the memory pool of the first graph, so the
two graphs, which never run at once, hold one pool between them, and then
replayed.  The capture that
follows makes no host draw and moves no host counter (the trainer's step
and optimizer count are put back, and every kernel's launch counter in
``ops/_build``'s registry too: each replay adds the captured launches to
them instead).  Where no graph is taken the
tape runs its steps eagerly: on the CPU (the plain version the tests hold
the graphs to) and on a mesh with a 'model' axis or FSDP (Megatron slices
and FSDP2 are not captured; each step is ``Trainer.train_step`` with the
tape's seeds).  A capture that fails raises; there is no other route.

On a mesh with a 'data' axis alone (no FSDP) the tape steps run as on one
device, a CUDA graph on the GPU: each rank's tape rows hold its own rows of
each batch, and each step's gradients are averaged over 'data' by one
all-reduce of one flat buffer (``ShardedModel.sync_grads``: NCCL, inside the
graph, as are the mesh-wide norm, whose AdamW tail reads the tape's
scalars, and the metrics' collectives).  Eager steps outside the tape keep
DDP; a capture first frees the DDP wrapper an eager step built
(``ShardedModel.drop_ddp``).

Tracing (``utils/tracing.py``, on while a profiler records): a 'dispatch'
span with 'dispatch.prepare', '.capture', '.launch' and '.mesh' inside it;
the graph's phase marks (event-record nodes, 4K + 1 in a K-step graph),
read at the start of the next dispatch; and after each traced replay an
end event, from which the next dispatch's gap is read.  With tracing off a
dispatch adds a few flag checks and the graph's event records.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.vit import seeds_per_forward
from ..ops import _build
from ..utils import tracing


def _uncounted(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, int]]:
    """``fn()`` and the kernel launches it made, by the launch registry
    (``ops/_build``), with the registry's counts put back: a graph's
    capture launches nothing, and each replay adds what it captured."""
    before = _build.launch_counts()
    out = fn()
    launches = {name: n - before[name] for name, n in _build.launch_counts().items()}
    _build.add_launches(launches, -1)
    return out, launches


def _replayed(graph, launches: Dict[str, int], times: int) -> None:
    """``times`` replays of ``graph``, each adding the ``launches`` its
    capture recorded to the registry."""
    for _ in range(times):
        graph.replay()
    _build.add_launches(launches, times)


def step_scalars(optimizer, count: int) -> np.ndarray:
    """[lr, bc1, bc2, -lr] in f32 for the step that takes the optimizer's
    count from ``count`` to ``count + 1``: the values ``FusedAdamW.lr_bc``
    and ``AdamChain.apply`` make from the count."""
    lr, bc1, bc2 = optimizer.lr_bc(count)
    return np.array([lr, bc1, bc2, -lr], np.float32)


class StepTape:
    """The steps of one dispatch in one int64 device buffer of ``steps`` rows:
    a row holds the step's ``bsz`` batch indices, its ``n_seeds`` dropout
    seeds as int32 (two to an int64 column) and [lr, bc1, bc2, -lr] as f32
    (two columns).  ``fill`` writes a pinned host twin and copies it over
    with one non-blocking copy; before it writes the twin again it waits for
    that copy (not for the steps that read the buffer: they are queued on
    the same stream after the copy).  On the CPU the twin is the buffer."""

    def __init__(self, steps: int, bsz: int, n_seeds: int, device: torch.device):
        self.bsz, self.n_seeds = bsz, n_seeds
        self._seed_cols = (n_seeds + 1) // 2
        self.width = bsz + self._seed_cols + 2
        cuda = device.type == 'cuda'
        self.host = torch.zeros((steps, self.width), dtype=torch.int64, pin_memory=cuda)
        self.dev = self.host.to(device) if cuda else self.host
        self._copied: Optional[torch.cuda.Event] = None

    def fill(self, takes: np.ndarray, seeds: np.ndarray, scalars: np.ndarray) -> None:
        """Rows 0..k-1 from ``takes`` (k, bsz), ``seeds`` (k, n_seeds), each a
        non-negative int32 (the range the kernels take, checked here, where
        it costs no device sync), and ``scalars`` (k, 4) f32."""
        k = len(takes)
        if seeds.size and not (seeds.min() >= 0 and seeds.max() < 2 ** 31):
            raise ValueError('dropout seeds must be non-negative int32')
        if self._copied is not None:
            self._copied.synchronize()
        h = self.host.numpy()
        h[:k, :self.bsz] = takes
        h[:k, self.bsz:self.bsz + self._seed_cols].view(np.int32)[:, :self.n_seeds] = seeds
        h[:k, self.width - 2:].view(np.float32)[:] = scalars
        if self.dev is not self.host:
            self.dev[:k].copy_(self.host[:k], non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()

    def views(self, row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(batch indices (bsz,) int64, seeds (n_seeds,) int32, [lr, bc1, bc2,
        -lr] (4,) f32) of a row: views, which a graph reads at replay."""
        seeds = row[self.bsz:self.bsz + self._seed_cols].view(torch.int32)[:self.n_seeds]
        return row[:self.bsz], seeds, row[self.width - 2:].view(torch.float32)


@dataclasses.dataclass
class Captured:
    """A captured dispatch: the graph, the tensors its replay writes the last
    step's metrics into, the device buffers it reads (kept alive with it),
    the kernel launches one replay makes, what the capture cost, and the
    phase marks every replay records."""
    graph: Any
    metrics: Dict[str, torch.Tensor]
    keep: List[torch.Tensor]
    launches: Dict[str, int]
    capture_s: float
    pool_bytes: int
    marks: tracing.StepMarks


class Dispatcher:
    """Runs ``steps`` steps of a ``Trainer`` per dispatch from a
    :class:`StepTape` (``scan``: the epoch_scan route, one graph of one
    cursor step replayed ``steps`` times)."""

    def __init__(self, trainer, steps: int, scan: bool):
        cfg = trainer.cfg
        self.tr, self.steps, self.scan = trainer, steps, scan
        self.device = trainer.device
        self.sigs, self.labs = trainer._split_arrays(trainer.train_data)
        n_seeds = max(1, cfg.grad_accum) * seeds_per_forward(trainer.model_cfg)
        mesh, sharded = trainer.mesh, trainer.sharded
        # a mesh with 'data' alone runs the tape steps; other meshes Trainer.train_step
        self.flat = sharded is not None and sharded.flat_sync
        n_data = mesh.shape['data'] if self.flat else 1
        self.tape = StepTape(steps, cfg.train_batch_size // n_data, n_seeds, self.device)
        self.losses = torch.zeros(steps, dtype=torch.float32, device=self.device)
        self.gnorms = torch.zeros(steps, dtype=torch.float32, device=self.device)
        self.nonfinite = trainer._nonfinite
        if scan:
            self.cursor = torch.zeros(1, dtype=torch.int64, device=self.device)
            self.row = torch.empty(self.tape.width, dtype=torch.int64, device=self.device)
        self.graphs: Dict[int, Captured] = {}   # by steps a replay (scan: 1, the cursor step)
        self.eager = self.device.type != 'cuda' or (mesh is not None and not self.flat)
        self.stream = None if self.eager else torch.cuda.Stream(self.device)
        self.replays = 0
        # traced replays' end events, two in turn (one is read before it is
        # recorded again), and the trainer's step after the last of them
        self._ends = None if self.eager else (torch.cuda.Event(enable_timing=True),
                                              torch.cuda.Event(enable_timing=True))
        self._end_step = None

    @property
    def captured(self) -> Optional[Captured]:
        """The graph of the dispatch's ``steps`` steps (scan: the cursor step)."""
        return self.graphs.get(1 if self.scan else self.steps)

    def info(self) -> Dict[str, Any]:
        """What the dispatches ran: the route ('graph' on one GPU, 'eager' on
        the CPU, 'mesh'), the steps a dispatch, the graph replays, and for a
        graph the capture's seconds, the memory it reserved and one replay's
        kernel launches."""
        mesh = self.tr.mesh is not None and not self.flat
        route = 'mesh' if mesh else 'eager' if self.eager else 'graph'
        out = {'route': route, 'scan': self.scan, 'steps': self.steps,
               'replays': self.replays,
               'data_ranks': self.tr.mesh.shape['data'] if self.flat else 1}
        if self.captured is not None:
            out.update(capture_s=self.captured.capture_s, pool_bytes=self.captured.pool_bytes,
                       graph_launches=dict(self.captured.launches))
        return out

    def run(self, takes: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """``len(takes)`` steps on the rows ``takes`` (k, bsz) of the train
        split: the first dispatch eagerly (then the capture), later ones as
        replays.  Returns the per-step losses and gradient norms (device
        tensors) and the last step's metrics (device tensors, the learning
        rate a float), as the per-step loop's ``train_step`` returns them."""
        tracing.collect()   # the last dispatch's marks, if traced: the replay records them again
        with tracing.span('dispatch', self.tr.step):
            return self._dispatch(takes, self.tr.step)

    def _dispatch(self, takes: np.ndarray, step: int):
        tr = self.tr
        k = len(takes)
        with tracing.span('dispatch.prepare', step):
            seeds = torch.randint(0, 1 << 31, (k * self.tape.n_seeds,),
                                  generator=tr.rng.host).numpy().reshape(k, self.tape.n_seeds)
            if tr.mesh is None or self.flat:
                scalars = self._prepare(takes, seeds)
        if tr.mesh is not None and not self.flat:
            with tracing.span('dispatch.mesh', step):
                return self._run_mesh(takes, seeds)
        key = 1 if self.scan else k
        if key in self.graphs:
            with tracing.span('dispatch.launch', step):
                metrics = self._replay(k)
        elif self.eager:
            with tracing.span('dispatch.launch', step):
                marks = tracing.step_marks(self.device)
                metrics = self._body(k, marks)
                marks.launched()
        elif not self.graphs:
            with tracing.span('dispatch.capture', step):
                marks = tracing.step_marks(self.device)
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self.stream):
                    metrics = self._body(k, marks)
                torch.cuda.current_stream(self.device).wait_stream(self.stream)
                marks.launched()
                self._capture(key)
        else:   # another step count: captured into the first graph's pool, then replayed
            with tracing.span('dispatch.capture', step):
                self._capture(key, next(iter(self.graphs.values())).graph.pool())
            with tracing.span('dispatch.launch', step):
                metrics = self._replay(k)
        # copies: the next dispatch writes the buffers again
        return (self.losses[:k].clone(), self.gnorms[:k].clone(),
                {'loss': metrics['loss'], 'learning_rate': float(scalars[-1, 0]),
                 **{key: v for key, v in metrics.items() if key != 'loss'}})

    def _prepare(self, takes: np.ndarray, seeds: np.ndarray) -> np.ndarray:
        """The tape filled for the dispatch's steps, the non-finite counter
        and the cursor set; returns the steps' [lr, bc1, bc2, -lr] rows."""
        tr = self.tr
        scalars = np.stack([step_scalars(tr.optimizer, tr.opt_state.count + i)
                            for i in range(len(takes))])
        if self.flat:   # this rank's rows of each batch
            accum = max(1, tr.cfg.grad_accum)
            takes = np.stack([tr._local_take(t, accum) for t in takes])
        self.tape.fill(takes, seeds, scalars)
        if tr._nonfinite is not self.nonfinite:   # a single step ran since the last dispatch
            self.nonfinite.copy_(tr._nonfinite)
            tr._nonfinite = self.nonfinite
        if self.scan:
            self.cursor.zero_()
        return scalars

    def _row(self, i: int):
        """Step ``i``'s views of the tape: row i, or (``scan``) the row at the
        cursor, gathered into the row buffer, with the cursor as the slot of
        its loss."""
        if not self.scan:
            return self.tape.views(self.tape.dev[i]), i
        torch.index_select(self.tape.dev, 0, self.cursor, out=self.row.view(1, -1))
        return self.tape.views(self.row), self.cursor

    def _body(self, n: int, marks) -> Dict[str, torch.Tensor]:
        """``n`` tape steps (``scan``: cursor steps); the per-step loss and
        gradient norm into their buffers, the non-finite counter back into
        the tensor the next dispatch reads.  ``marks``: the steps' phase
        marks (``utils.tracing``), each step's tail ending after its copies."""
        tr = self.tr
        for i in range(n):
            metrics = self._tape_step(i, marks)
        self.nonfinite.copy_(tr._nonfinite)
        tr._nonfinite = self.nonfinite
        return metrics

    def _tape_step(self, i: int, marks) -> Dict[str, torch.Tensor]:
        """Step ``i`` of the tape, its loss and gradient norm into their slots."""
        (idx, seeds, scal), slot = self._row(i)
        metrics = self.tr._tape_step(self.sigs, self.labs, idx, seeds, scal, marks)
        if self.scan:
            self.losses.index_copy_(0, slot, metrics['loss'].reshape(1))
            self.gnorms.index_copy_(0, slot, metrics['grad_norm'].reshape(1))
            self.cursor.add_(1)
        else:
            self.losses[slot].copy_(metrics['loss'])
            self.gnorms[slot].copy_(metrics['grad_norm'])
        marks.mark('tail')
        return metrics

    def _capture(self, steps: int, pool=None) -> None:
        """Capture a dispatch of ``steps`` steps (``scan``: one cursor step)
        with the host state put back after it, so the capture itself counts
        no step; ``pool``: the memory pool of the graph captured first."""
        from ..ops.adamw import adamw_kernel
        from .optim import FusedAdamW
        tr = self.tr
        if isinstance(tr.optimizer, FusedAdamW):   # #5's buffers, outside the graph's pool
            adamw_kernel.reserve(steps)
        if tr.sharded is not None:   # an eager step's DDP wrapper would break the capture
            tr.sharded.drop_ddp()
        saved = (tr.step, tr.opt_state)
        marks = tracing.StepMarks(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in {id(g): g for g in (tr.rng.device, tr.rng.masks)}.values():
            graph.register_generator_state(gen)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()   # as the capture does on entry: the delta is its pool
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, stream=self.stream):
            metrics, launches = _uncounted(lambda: self._body(steps, marks))
        capture_s = time.perf_counter() - t0
        tr.step, tr.opt_state = saved
        self.graphs[steps] = Captured(graph, metrics, adamw_kernel.take_captured(), launches,
                                      capture_s,
                                      torch.cuda.memory_reserved(self.device) - reserved, marks)

    def _replay(self, k: int) -> Dict[str, torch.Tensor]:
        """The dispatch as replays: one of the K-step graph, or ``k`` of the
        cursor step; the host counters advanced by ``k`` steps and the launch
        counters by what the replays launched.  Traced: the graph's marks
        are handed to the recorder (``scan``: the last replay's step, and no
        gap), and an end event follows the replays."""
        tr, cap = self.tr, self.graphs[1 if self.scan else k]
        replays = k if self.scan else 1
        traced = tracing.enabled()
        _replayed(cap.graph, cap.launches, replays)
        if traced:
            back_to_back = self._end_step == tr.step and not self.scan
            cap.marks.launched(self._ends[1] if back_to_back else None)
            self._ends[0].record()
            self._ends = self._ends[::-1]
            self._end_step = tr.step + k
        self.replays += replays
        tr.step += k
        tr.opt_state = dataclasses.replace(tr.opt_state, count=tr.opt_state.count + k)
        return cap.metrics

    def _run_mesh(self, takes: np.ndarray, seeds: np.ndarray):
        """On a mesh: the dispatch's steps one after another through
        ``train_step``, each taking its seeds from the tape's host rows."""
        tr = self.tr
        losses, gnorms = [], []
        for take, row in zip(takes, seeds.tolist()):
            with tr.rng.taped(row):
                metrics = tr.train_step(tr.train_data, take)
            losses.append(metrics['loss'])
            gnorms.append(metrics['grad_norm'])
        return torch.stack(losses), torch.stack(gnorms), metrics
