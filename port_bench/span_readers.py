"""The per-layer metrics read from the program's own tracing
(``ecg_representation_learning_tpu_torch.utils.tracing``): the training
step's phases on the device's clock, the device's idle gap at each dispatch
boundary, and the host time of the dispatch layer's preparation.

Each takes the run (``harness.Run``) and returns a number, or None where
nothing was counted: the program was not traced, ran no such span or mark,
or has no recorder at all (a checkout from before it).  The recorder holds
only what ran while a profiler recorded, which in a run is the traced slice.
"""
from __future__ import annotations

from typing import Optional

from .readers import _on_card


def _snapshot() -> Optional[dict]:
    try:
        from ecg_representation_learning_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def _phase_ms(phase: str) -> Optional[float]:
    """Device ms a step of the phase ``phase`` (CUDA events on the card, the
    host clock on the CPU, where the step runs synchronously)."""
    s = _snapshot()
    p = s['phases'].get(phase) if s else None
    if not p or not p['steps']:
        return None
    return 1e3 * p['device_s'] / p['steps']


def step_forward_ms(r) -> Optional[float]:
    return _phase_ms('forward')


def step_backward_ms(r) -> Optional[float]:
    return _phase_ms('backward')


def step_update_ms(r) -> Optional[float]:
    return _phase_ms('update')


def dispatch_gap_ms(r) -> Optional[float]:
    """The device's idle ms from one graph dispatch's end to the next one's
    first mark, back to back (on the card only)."""
    s = _snapshot()
    if not _on_card(r) or not s or not s['gaps']['count']:
        return None
    return 1e3 * s['gaps']['device_s'] / s['gaps']['count']


def dispatch_host_ms(r) -> Optional[float]:
    """Host ms a dispatch spends in its 'dispatch.prepare' span: the seed
    draw, the step scalars and the tape's fill.  Not 'dispatch.launch': under
    the profiler a graph launch's host time is mostly CUPTI's (~17 ms against
    ~1 ms without it), which would hide any change to the launch or to the
    preparation; the launches are counted by ``launch_calls_per_step``."""
    s = _snapshot()
    prep = s['spans'].get('dispatch.prepare') if s else None
    if not prep or not prep['count']:
        return None
    return 1e3 * prep['host_s'] / prep['count']
