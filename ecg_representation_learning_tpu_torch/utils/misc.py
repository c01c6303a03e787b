"""Host utilities (the JAX package's ``utils/misc.py``): human-readable
formatting, profiling, and (from ``utils/tracing.py``, where they live with
the port's spans) a device trace and the step timer.

Reference util/util.py:147-221: ``readable_int`` (SI suffixes), ``fmt_time``
(delta -> h:m:s), ``profile_runtime`` (cProfile wrapper).  ``device_trace`` is
a ``torch.profiler`` context (CPU and CUDA activities) that writes a Chrome
trace, where the JAX package captures a ``jax.profiler`` trace.
``StepTimer`` splits a train loop's time into input wait and step time on the
host clock (the time to queue a step unless the loop reads a device value).
"""
from __future__ import annotations

import cProfile
import datetime
import io
import pstats
from typing import Callable, Union

from .tracing import StepTimer, device_trace  # noqa: F401  (the JAX package's names here)


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
