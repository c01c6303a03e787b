"""TimeOut: zero a random time span per sample (the JAX ``ops/augment.timeout``).

Reference ``TimeOut`` (transform.py:175-185): a contiguous span whose length
is a Uniform(lo, hi) fraction of the signal, shared across the leads of a
sample, zeroed on training batches only.  A masked select over the whole
batch on the device.
"""
from __future__ import annotations

from typing import Optional

import torch


def timeout(x: torch.Tensor, lo: float = 0.0, hi: float = 0.5,
            generator: Optional[torch.Generator] = None,
            span_draw: Optional[torch.Tensor] = None,
            start_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero a random time span per sample of ``x`` (..., C, L).

    ``span_draw`` (the span as a fraction of L, in [lo, hi)) and
    ``start_draw`` (in [0, 1)) have the batch shape x.shape[:-2]; each one
    not given is drawn from ``generator`` (on x's device).  As in JAX:
    span = round(span_draw * L), start = floor(start_draw * (L - span))."""
    length = x.shape[-1]
    batch_shape = x.shape[:-2] if x.dim() >= 2 else ()
    if span_draw is None:
        span_draw = lo + (hi - lo) * torch.rand(batch_shape, generator=generator,
                                                device=x.device)
    if start_draw is None:
        start_draw = torch.rand(batch_shape, generator=generator, device=x.device)
    span = torch.round(span_draw * length).to(torch.int32)
    start = torch.floor(start_draw * (length - span)).to(torch.int32)
    pos = torch.arange(length, device=x.device)
    start_b, span_b = start[..., None, None], span[..., None, None]
    mask = (pos >= start_b) & (pos < start_b + span_b)
    return torch.where(mask, 0.0, x)
