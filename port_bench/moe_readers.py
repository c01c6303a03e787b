"""The per-layer metrics of the MoE layer and of the data-parallel mesh:
the MoE layer's device phases and counters (``models/moe.py``'s
``DeepseekMoe``) and the gradient all-reduce's device time.

Each takes the run (``harness.Run``) and returns a number, or None where
nothing was counted: the program was not traced, has no such layer, or has
no recorder or counter of the kind (a checkout from before them).
"""
from __future__ import annotations

from typing import Optional

from . import yardstick_moe
from .span_readers import _snapshot


def _region_ms(*phases: str) -> Optional[float]:
    """Device ms a step of the region marks ``phases`` (the step count is the
    'forward' phase's)."""
    s = _snapshot()
    if not s:
        return None
    fwd = s['phases'].get('forward')
    got = [s['phases'][p]['device_s'] for p in phases if p in s['phases']]
    if not fwd or not fwd['steps'] or not got:
        return None
    return 1e3 * sum(got) / fwd['steps']


def experts_ms(r) -> Optional[float]:
    """The held experts' forward (grouped GEMMs and SwiGLU), device ms a step."""
    return _region_ms('moe.experts')


def route_ms(r) -> Optional[float]:
    """Routing, the permutation by expert and the combine, device ms a step."""
    return _region_ms('moe.route', 'moe.permute', 'moe.combine')


def allreduce_ms(r) -> Optional[float]:
    """The gradient all-reduce, device ms a step (rank 0's marks)."""
    return _region_ms('allreduce')


def load_max(r) -> Optional[float]:
    """The busiest held expert's rows over the held experts' mean rows, per
    MoE layer and step, over the window."""
    w = r.window
    if not w.get('moe_held_rows'):
        return None
    return w['moe_busiest_rows'] / (w['moe_held_rows'] / w['moe_held_experts'])


GROUPED_GEMM_KERNELS = ('GroupProblemShape',)


def gemm_roofline(r) -> Optional[float]:
    """The held experts' grouped GEMMs (forward and backward) in the traced
    slice: their matmul FLOPs, from the held-row counter, over their kernels'
    device time, a share (%) of the card's bf16 peak."""
    rows = r.window.get('trace_held_rows')
    t = r.tr.kernel_s(*GROUPED_GEMM_KERNELS) if r.tr else 0.0
    if not rows or not t:
        return None
    flops = yardstick_moe.grouped_gemm_flops(r.config, rows)
    return 100.0 * flops / t / yardstick_moe.H100_BF16_FLOPS
