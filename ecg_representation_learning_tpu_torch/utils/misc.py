"""Host utilities (the JAX package's ``utils/misc.py``): human-readable
formatting, profiling, a device trace and the step timer.

Reference util/util.py:147-221: ``readable_int`` (SI suffixes), ``fmt_time``
(delta -> h:m:s), ``profile_runtime`` (cProfile wrapper).  ``device_trace`` is
a ``torch.profiler`` context (CPU and CUDA activities) that writes a Chrome
trace, where the JAX package captures a ``jax.profiler`` trace.
``StepTimer`` splits a train loop's time into input wait and step time on the
host clock.  The port dispatches steps asynchronously, as JAX does, so the
"compute" side is the time to queue a step unless something in it waits for
the device (a logged loss, a checkpoint); read it beside the device's busy
share from a profile.
"""
from __future__ import annotations

import contextlib
import cProfile
import datetime
import io
import os
import pstats
import time
from typing import Callable, Dict, Union


def readable_int(num: int, suffix: str = '') -> str:
    """1234567 -> '1.2M' (reference util.py:147-155)."""
    magnitude = 0
    n = float(num)
    while abs(n) >= 1000 and magnitude < 5:
        magnitude += 1
        n /= 1000.0
    return f'{n:.1f}{["", "K", "M", "B", "T", "Q"][magnitude]}{suffix}'


def fmt_time(delta: Union[float, datetime.timedelta]) -> str:
    """Seconds/timedelta -> 'Hh Mm Ss' (reference fmt_time, util.py:178-191)."""
    if isinstance(delta, datetime.timedelta):
        delta = delta.total_seconds()
    delta = int(round(delta))
    h, rem = divmod(delta, 3600)
    m, s = divmod(rem, 60)
    parts = []
    if h:
        parts.append(f'{h}h')
    if m or h:
        parts.append(f'{m}m')
    parts.append(f'{s}s')
    return ' '.join(parts)


def profile_runtime(fn: Callable, *args, sort_by: str = 'cumtime',
                    top: int = 30, **kwargs):
    """cProfile wrapper printing the hottest entries (reference util.py:194-205)."""
    prof = cProfile.Profile()
    result = prof.runcall(fn, *args, **kwargs)
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats(sort_by).print_stats(top)
    print(buf.getvalue())
    return result


@contextlib.contextmanager
def device_trace(log_dir: str = 'traces'):
    """``torch.profiler`` over the block (CPU, and CUDA when a GPU is
    visible), written to ``{log_dir}/trace.json`` as a Chrome trace (open it in
    Perfetto or chrome://tracing).  Yields the trace file's path."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, 'trace.json')
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


class StepTimer:
    """Train-loop timer splitting step time into input vs compute wait.

    Call ``input_done()`` after the batch is ready and ``step_done()`` after
    the step returns; ``summary()`` reports the input-bound fraction (the
    counter the reference lacks entirely -- its pipeline is 100% input-bound
    by construction, dataset.py:93).
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
