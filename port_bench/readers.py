"""The per-layer metrics' arithmetic, shared by the readers in ``metrics/``.

Each takes the run (``harness.Run``) and returns a number, or None where the
run has nothing to read: no traced slice, no device, or no work of the kind.
A share of a peak or a roofline is never made up as 0.
"""
from __future__ import annotations

from typing import Optional

from . import yardstick


def _on_card(r) -> bool:
    return str(r.device).startswith('cuda')


def mfu(r) -> Optional[float]:
    """The window's matmul FLOPs over its wall time, as a share (%) of the
    card's bf16 peak (host clock, untraced window of the traced run)."""
    w = r.window
    if not _on_card(r) or not w.get('samples'):
        return None
    return 100.0 * w['samples'] * w['flops_per_sample'] / w['seconds'] / yardstick.H100_BF16_FLOPS


def adamw_roofline(r) -> Optional[float]:
    """Kernel #5's share (%) of its bound: the bytes one AdamW step must move
    over the card's bandwidth, over the device time of its norm and update
    launches a step in the traced slice."""
    t = r.tr.kernel_s('adamw_update_kernel', 'adamw_norm_kernel') if r.tr else 0.0
    if not t or not r.tr.units:
        return None
    return 100.0 * yardstick.adamw_bound_s(r.window['params']) * r.tr.units / t


def launch_calls_per_step(r) -> Optional[float]:
    """The host's kernel and graph launch calls per optimizer step."""
    if not r.tr or r.tr.busy_s is None or not r.tr.units:
        return None
    return r.tr.launch_calls / r.tr.units


def device_idle(r) -> Optional[float]:
    """The share (%) of the traced slice in which no device op ran."""
    if not r.tr or r.tr.busy_s is None or not r.tr.window_s:
        return None
    return 100.0 * (1.0 - r.tr.busy_s / r.tr.window_s)


def input_wait_share(r) -> Optional[float]:
    """The share (%) of the window the training loop spent waiting for the
    next batch from its iterator."""
    w = r.window
    if not _on_card(r) or 'input_wait_s' not in w:
        return None
    return 100.0 * w['input_wait_s'] / w['seconds']


def requests_per_dispatch(r) -> Optional[float]:
    s = r.serve
    if not s.get('calls'):
        return None
    return s['rows'] / s['calls']


def dispatch_ms(r) -> Optional[float]:
    s = r.serve
    if not _on_card(r) or not s.get('calls'):
        return None
    return 1e3 * s['call_s'] / s['calls']
