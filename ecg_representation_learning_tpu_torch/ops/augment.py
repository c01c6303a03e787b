"""Signal augmentations (the JAX ``ops/augment``): TimeOut and the
contrastive-view family.

Reference ``TimeOut`` (transform.py:175-185): a contiguous span whose length
is a Uniform(lo, hi) fraction of the signal, shared across the leads of a
sample, zeroed on training batches only.  The contrastive views add an
amplitude gain, additive jitter, lead dropout and a circular time shift;
none stretches the waveform, so beat shapes survive every view.  All are
masked or gathered ops over the whole batch on the device.

Every random draw can be passed in as a tensor (the JAX package's draws, in
the tests); a draw not given comes from ``generator`` on x's device, with the
JAX draw's shape and range.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


def _batch_shape(x: torch.Tensor):
    return x.shape[:-2] if x.dim() >= 2 else ()


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def timeout_draws(batch_shape, lo: float = 0.0, hi: float = 0.5,
                  generator: Optional[torch.Generator] = None, device=None):
    """(span_draw, start_draw) of :func:`timeout` for ``batch_shape``, drawn
    from ``generator`` as ``timeout`` draws them."""
    span = _uniform(batch_shape, lo, hi, generator, device)
    return span, torch.rand(batch_shape, generator=generator, device=device)


def timeout(x: torch.Tensor, lo: float = 0.0, hi: float = 0.5,
            generator: Optional[torch.Generator] = None,
            span_draw: Optional[torch.Tensor] = None,
            start_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero a random time span per sample of ``x`` (..., C, L).

    ``span_draw`` (the span as a fraction of L, in [lo, hi)) and
    ``start_draw`` (in [0, 1)) have the batch shape x.shape[:-2].  As in JAX:
    span = round(span_draw * L), start = floor(start_draw * (L - span))."""
    length = x.shape[-1]
    if span_draw is None or start_draw is None:
        span, start = timeout_draws(_batch_shape(x), lo, hi, generator, x.device)
        span_draw = span if span_draw is None else span_draw
        start_draw = start if start_draw is None else start_draw
    span = torch.round(span_draw * length).to(torch.int32)
    start = torch.floor(start_draw * (length - span)).to(torch.int32)
    pos = torch.arange(length, device=x.device)
    start_b, span_b = start[..., None, None], span[..., None, None]
    mask = (pos >= start_b) & (pos < start_b + span_b)
    return torch.where(mask, 0.0, x)


def amplitude_scale(x: torch.Tensor, lo: float = 0.8, hi: float = 1.25,
                    generator: Optional[torch.Generator] = None,
                    gain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multiply each sample by one gain in [lo, hi) (``gain``: batch shape),
    shared across leads so the relative lead amplitudes survive."""
    if gain is None:
        gain = _uniform(_batch_shape(x), lo, hi, generator, x.device)
    return x * gain[..., None, None]


def gaussian_jitter(x: torch.Tensor, sigma: float = 0.05,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add standard-normal ``noise`` (x's shape) scaled by ``sigma`` times each
    sample's own std (population std over leads and time)."""
    std = x.std(dim=(-2, -1), keepdim=True, correction=0)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + noise * (sigma * std)


def channel_dropout(x: torch.Tensor, rate: float = 0.2,
                    generator: Optional[torch.Generator] = None,
                    keep_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero each lead with probability ``rate``: lead kept iff its
    ``keep_draw`` (uniform [0, 1), shape x.shape[:-1]) >= rate.  A sample
    whose draw would drop every lead keeps them all."""
    if keep_draw is None:
        keep_draw = torch.rand(x.shape[:-1], generator=generator, device=x.device)
    keep = keep_draw >= rate
    keep = keep | ~keep.any(dim=-1, keepdim=True)
    return x * keep[..., None].to(x.dtype)


def time_shift(x: torch.Tensor, max_frac: float = 0.5,
               generator: Optional[torch.Generator] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Circular roll of each sample by ``shift`` (integers in
    [0, round(max_frac * L)), batch shape): out[..., t] = x[..., (t + shift) % L]."""
    length = x.shape[-1]
    batch_shape = _batch_shape(x)
    max_shift = max(int(round(max_frac * length)), 1)
    if shift is None:
        shift = torch.randint(0, max_shift, batch_shape, generator=generator,
                              device=x.device)
    pos = torch.arange(length, device=x.device)
    idx = (pos + shift[..., None].long()) % length                  # (..., L)
    return torch.gather(x, -1, idx[..., None, :].expand(x.shape))


def view_draws(shape, *, scale_lo: float = 0.8, scale_hi: float = 1.25,
               jitter_sigma: float = 0.05, lead_dropout: float = 0.2,
               shift_frac: float = 0.5, timeout_hi: float = 0.25,
               generator: Optional[torch.Generator] = None, device=None,
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The draws :func:`contrastive_view` makes from ``generator`` for an
    input of ``shape`` (B, C, L), in its order, as its ``draws``: the
    trainers on a mesh draw them for the global batch and keep their rows."""
    b, c, length = shape
    g, d = generator, {}
    if shift_frac > 0:
        max_shift = max(int(round(shift_frac * length)), 1)
        d['shift'] = torch.randint(0, max_shift, (b,), generator=g, device=device)
    if scale_lo != 1.0 or scale_hi != 1.0:
        d['gain'] = _uniform((b,), scale_lo, scale_hi, g, device)
    if lead_dropout > 0:
        d['keep_draw'] = torch.rand((b, c), generator=g, device=device)
    if jitter_sigma > 0:
        d['noise'] = torch.randn((b, c, length), generator=g, device=device, dtype=dtype)
    if timeout_hi > 0:
        d['span_draw'], d['start_draw'] = timeout_draws((b,), 0.0, timeout_hi, g, device)
    return d


def contrastive_view(x: torch.Tensor, *, scale_lo: float = 0.8, scale_hi: float = 1.25,
                     jitter_sigma: float = 0.05, lead_dropout: float = 0.2,
                     shift_frac: float = 0.5, timeout_hi: float = 0.25,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    """One stochastic view: shift -> scale -> lead dropout -> jitter ->
    timeout (last, so jitter does not refill its zero span).  A stage whose
    knob is zero (or the scale range [1, 1]) is skipped and draws nothing.

    ``draws`` may hold any of ``shift``, ``gain``, ``keep_draw``, ``noise``,
    ``span_draw`` and ``start_draw`` (the stages' arguments); the rest are
    drawn from ``generator`` in stage order."""
    d = dict(draws or {})
    g = generator
    if shift_frac > 0:
        x = time_shift(x, shift_frac, g, shift=d.get('shift'))
    if scale_lo != 1.0 or scale_hi != 1.0:
        x = amplitude_scale(x, scale_lo, scale_hi, g, gain=d.get('gain'))
    if lead_dropout > 0:
        x = channel_dropout(x, lead_dropout, g, keep_draw=d.get('keep_draw'))
    if jitter_sigma > 0:
        x = gaussian_jitter(x, jitter_sigma, g, noise=d.get('noise'))
    if timeout_hi > 0:
        x = timeout(x, 0.0, timeout_hi, g, span_draw=d.get('span_draw'),
                    start_draw=d.get('start_draw'))
    return x
