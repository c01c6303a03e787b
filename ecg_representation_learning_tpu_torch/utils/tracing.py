"""The port's tracing: host spans and device timing marks at the phase
boundaries of the training step, the operator's device trace and the
step timer.

One switch.  Tracing is on while a ``torch.profiler`` session records in this
process (``enabled()``): the benchmark's traced slice, ``device_trace`` or any
other profiler.  No environment variable, config field or flag turns it on.
Off, ``span`` returns one shared no-op context, for one flag check (``torch.autograd._profiler_enabled()``, ~0.2 us on
a CPU), and no profiler range is opened: ``record_function``'s own
bookkeeping costs ~12 us a range even with no profiler running.

On:
  * ``span(name, parent_id)`` opens a profiler range, so the span sits on
    the profiler's clock beside the device's kernels, and adds one to its
    count and its host seconds (``time.perf_counter``) in memory.  The range
    is a function-scope ``RecordFunction`` (``_RecordFunctionFast``, as
    ``torch.compile`` labels its regions), with ``parent_id`` as its one
    input, which a trace taken with ``record_shapes`` (``device_trace``'s)
    shows.  Not a
    user-scope ``record_function``: for those the CUDA trace adds a device
    event over the range's kernels, gaps between them included, which a
    reader of device busy time would count as busy.  Spans opened during a
    CUDA graph capture are not recorded (they would time the capture, once,
    and not the replays);
  * ``StepMarks`` from ``step_marks`` record the phase boundaries of an
    eager step (outside a capture they are recorded only when on).

The spans: 'dispatch' (its argument the trainer's step at its start, which
its children share) with 'dispatch.prepare' (seed draw, step scalars, the
step tape's fill with its wait on the previous copy), 'dispatch.capture' (the
first dispatch's eager body and the capture), 'dispatch.launch' (the replay
or replays, or the eager route's steps) and 'dispatch.mesh' (the mesh route's
steps), all in ``train/dispatch.py``; 'step.forward', 'step.backward' and
'step.update' in ``train/loop.py::grad_accum`` and ``TrainerBase._update``
(eager steps only); 'train.read' around the host read of each payload in
``Trainer.train()``'s loops.  The phases (``StepMarks``): 'forward' (gather,
z-norm, ``time_end_pad``, forward, BCE), 'backward', 'update' (``_update``:
the norm and clip, the optimizer, EMA, the non-finite counter, clearing the
gradients) and 'tail' (the step's metrics and, in a tape step, their copies
into the dispatch's buffers), summed over the microbatches of a step.  The
gap: on the card, the device time from one graph dispatch's end to the first
mark of the next, back to back (no step in between), read on the device's
clock.

``snapshot()`` returns what was recorded::

    {'spans': {name: {'count', 'host_s'}}, 'phases': {name: {'steps', 'device_s'}},
     'gaps': {'count', 'device_s'}}

``StepTimer`` and ``device_trace`` are the operator's tools, re-exported by
``utils.misc`` and ``utils`` as the JAX package names them.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """True while a ``torch.profiler`` session records in this process."""
    return torch.autograd._profiler_enabled()


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class _Span:
    __slots__ = ('name', 'range', 't0')

    def __init__(self, name: str, args: tuple):
        self.name = name
        self.range = torch._C._profiler._RecordFunctionFast(name, *args)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        entry = RECORDER.spans.setdefault(self.name, [0, 0.0])
        entry[0] += 1
        entry[1] += seconds
        return False


def span(name: str, parent_id: Optional[int] = None):
    """A host span over a ``with`` block (see the module docstring); when
    off, or inside a CUDA graph capture, a shared no-op context."""
    if not torch.autograd._profiler_enabled() or _capturing():
        return _OFF
    return _Span(name, () if parent_id is None else ([parent_id],))


class StepMarks:
    """Timing marks at the phase boundaries of consecutive steps on
    ``device``: ``start()`` records the first step's start mark (a later
    step starts at the previous one's end), ``mark(phase)`` a mark at the
    end of ``phase``, a step's last mark ends 'tail'.  ``launched(gap_from)``
    hands the recording to the recorder, which reads it once its last mark
    has completed (``collect``).

    On the card a mark is a ``torch.cuda.Event(enable_timing=True,
    external=True)``.  Recorded during a CUDA graph capture, the events
    become the graph's event-record nodes, which every replay records again
    (a K-step graph gains 4K + 1 of them), so a graph's marks are read
    before its next replay.  On the CPU a mark is ``time.perf_counter_ns()``:
    the step runs synchronously there."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'
        self.ends: List[Optional[str]] = []    # the phase each mark ends (None: the start)
        self.marks: List[Any] = []

    def start(self) -> None:
        if not self.marks:
            self._record(None)

    def mark(self, phase: str) -> None:
        self._record(phase)

    def _record(self, phase: Optional[str]) -> None:
        if self.cuda:
            m = torch.cuda.Event(enable_timing=True, external=True)
            m.record()
        else:
            m = time.perf_counter_ns()
        self.marks.append(m)
        self.ends.append(phase)

    def launched(self, gap_from=None) -> None:
        """The marks were recorded (an eager step) or replayed (a graph)
        while on: read them at the next ``collect``.  ``gap_from``: the end
        event of the dispatch before, back to back."""
        RECORDER.pending.append((self, gap_from))

    def completed(self) -> bool:
        return not self.cuda or self.marks[-1].query()

    def read(self, gap_from=None) -> Tuple[Dict[str, float], int, Optional[float]]:
        """(seconds by phase, steps, the gap in seconds or None) of the
        marks' last recording (waits for the last mark)."""
        if self.cuda:
            self.marks[-1].synchronize()
            t = [self.marks[0].elapsed_time(m) * 1e-3 for m in self.marks]
            gap = None if gap_from is None else gap_from.elapsed_time(self.marks[0]) * 1e-3
        else:
            t = [(m - self.marks[0]) * 1e-9 for m in self.marks]
            gap = None
        by: Dict[str, float] = {}
        for i in range(1, len(t)):
            by[self.ends[i]] = by.get(self.ends[i], 0.0) + t[i] - t[i - 1]
        return by, self.ends.count('tail'), gap


class _NoMarks:
    """The marks of a step launched while off: nothing is recorded."""

    def start(self) -> None:
        pass

    def mark(self, phase: str) -> None:
        pass

    def launched(self, gap_from=None) -> None:
        pass


NO_MARKS = _NoMarks()


def step_marks(device):
    """The marks of an eager launch of steps: recorded when on, else
    ``NO_MARKS``.  (A graph's marks are a ``StepMarks`` recorded during its
    capture, and again by every replay.)"""
    return StepMarks(device) if torch.autograd._profiler_enabled() else NO_MARKS


class Recorder:
    """The in-memory tables of one process (``RECORDER``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.spans: Dict[str, List[float]] = {}
        self.phases: Dict[str, List[float]] = {}
        self.gaps = [0, 0.0]
        self.pending: List[Tuple[StepMarks, Any]] = []

    def collect(self, wait: bool = True) -> None:
        """Read the pending marks (``wait`` False: those complete now)."""
        left = []
        for marks, gap_from in self.pending:
            if not wait and not marks.completed():
                left.append((marks, gap_from))
                continue
            by, steps, gap = marks.read(gap_from)
            for phase, seconds in by.items():
                entry = self.phases.setdefault(phase, [0, 0.0])
                entry[0] += steps
                entry[1] += seconds
            if gap is not None:
                self.gaps[0] += 1
                self.gaps[1] += gap
        self.pending = left

    def snapshot(self) -> Dict[str, Any]:
        self.collect()
        return {'spans': {n: {'count': c, 'host_s': s} for n, (c, s) in self.spans.items()},
                'phases': {n: {'steps': c, 'device_s': s} for n, (c, s) in self.phases.items()},
                'gaps': {'count': self.gaps[0], 'device_s': self.gaps[1]}}


RECORDER = Recorder()


def collect(wait: bool = True) -> None:
    """Read the marks launched while on that are still unread."""
    if RECORDER.pending:
        RECORDER.collect(wait)


def snapshot() -> Dict[str, Any]:
    """What was recorded since the last ``reset`` (see the module docstring)."""
    return RECORDER.snapshot()


def reset() -> None:
    RECORDER.reset()


@contextlib.contextmanager
def device_trace(log_dir: str = 'traces'):
    """``torch.profiler`` over the block (CPU, and CUDA when a GPU is
    visible), written to ``{log_dir}/trace.json`` as a Chrome trace (open it in
    Perfetto or chrome://tracing), with the operators' input shapes and the
    spans' arguments (``dispatch``'s step).  Yields the trace file's path."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, 'trace.json')
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        yield path
    prof.export_chrome_trace(path)


class StepTimer:
    """Train-loop timer splitting step time into input vs compute wait.

    Call ``input_done()`` after the batch is ready and ``step_done()`` after
    the step returns; ``summary()`` reports the input-bound fraction (the
    counter the reference lacks entirely -- its pipeline is 100% input-bound
    by construction, dataset.py:93).

    Both sides are host clock.  The port queues a step on the device and
    returns, so ``compute_s`` and ``steps_per_sec`` are the time to enqueue
    the steps, not to run them, unless the loop reads a device value (a
    logged loss, a checkpoint) before ``step_done()``; the device's time
    comes from a profile (``device_trace``) or the step's phase marks.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.input_s = 0.0
        self.compute_s = 0.0
        self.steps = 0

    def input_done(self):
        now = time.perf_counter()
        self.input_s += now - self._t0
        self._t0 = now

    def step_done(self):
        now = time.perf_counter()
        self.compute_s += now - self._t0
        self._t0 = now
        self.steps += 1

    def summary(self) -> Dict[str, float]:
        total = self.input_s + self.compute_s
        return {
            'steps': self.steps,
            'input_s': round(self.input_s, 4),
            'compute_s': round(self.compute_s, 4),
            'input_fraction': round(self.input_s / total, 4) if total else 0.0,
            'steps_per_sec': round(self.steps / total, 2) if total else 0.0,
        }
