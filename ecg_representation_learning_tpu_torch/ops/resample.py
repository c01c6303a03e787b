"""Sampling-rate conversion to the common 250 Hz grid (JAX package
``ops/resample.py``).

The reference resamples every lead with ``wfdb.processing.resample_sig``
(data_export.py:205-215), which is scipy's FFT resampler; the MATLAB export
uses polyphase ``resample(sig, p, q)`` (DataPreprocessor.m:45-54).  Registry
fqs fields imply the ratios 500->250, 1000->250, 257->250 and 400->250.
Batched over leading (record, lead) axes:

- :func:`resample_fft` -- ``scipy.signal.resample`` through ``torch.fft``;
- :func:`resample_poly` -- polyphase FIR (scipy ``resample_poly``): a
  host-designed Kaiser-windowed FIR over the zero-stuffed signal, applied as
  the framed Toeplitz product of :mod:`.filter` with the output stride.  (Not
  ``conv1d``: cuDNN runs f32 convolutions in TF32 by default.)
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .filter import fir_correlate_matmul


def resample_fft(x: torch.Tensor, num: int) -> torch.Tensor:
    """FFT-based resampling of the last axis to ``num`` samples.

    Matches ``scipy.signal.resample`` for real input (rfft bin copy with the
    even-length Nyquist-bin corrections, irfft back, amplitude rescale).
    """
    n = x.shape[-1]
    if num == n:
        return x
    X = torch.fft.rfft(x, dim=-1)
    n_keep = min(num, n)
    nyq = n_keep // 2 + 1
    Y = X[..., :nyq].clone()
    if n_keep < n:      # downsampling: fold energy at the new Nyquist bin
        if n_keep % 2 == 0:
            Y[..., n_keep // 2] *= 2.0
    elif n_keep < num:  # upsampling: split the old Nyquist bin
        if n_keep % 2 == 0:
            Y[..., n_keep // 2] *= 0.5
    pad = num // 2 + 1 - Y.shape[-1]
    if pad > 0:
        Y = F.pad(Y, (0, pad))
    y = torch.fft.irfft(Y, num, dim=-1)
    return y * (num / n)


@functools.lru_cache(maxsize=None)
def _poly_design(up: int, down: int, window_beta: float = 5.0):
    """Host-side polyphase FIR design mirroring scipy.signal.resample_poly."""
    from scipy import signal
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == down == 1:
        return up, down, None, 0
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    h = signal.firwin(2 * half_len + 1, f_c, window=('kaiser', window_beta))
    h = h * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    return up, down, (h, n_pre_pad, n_pre_remove), half_len


def resample_poly(x: torch.Tensor, up: int, down: int,
                  window_beta: float = 5.0) -> torch.Tensor:
    """Polyphase rational resampling of the last axis by up/down.

    Matches ``scipy.signal.resample_poly`` (Kaiser beta=5 default): upsample by
    zero-insertion, FIR low-pass, keep every ``down``-th sample -- one framed
    product with stride ``down`` over the zero-stuffed, edge-padded signal.
    """
    up0, down0, design, half_len = _poly_design(up, down, window_beta)
    if design is None:
        return x
    up, down = up0, down0
    h, n_pre_pad, n_pre_remove = design
    n_in = x.shape[-1]
    n_out = (n_in * up) // down + bool((n_in * up) % down)

    def output_len(len_h):
        return ((n_in - 1) * up + len_h + (down - 1)) // down

    n_post_pad = 0
    while output_len(len(h) + n_pre_pad + n_post_pad) < n_out + n_pre_remove:
        n_post_pad += 1
    hp = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    K = len(hp)

    if up > 1:
        # upfirdn's zero-stuffing: x[j] at j * up, zeros between
        stuffed = x.new_zeros(x.shape[:-1] + ((n_in - 1) * up + 1,))
        stuffed[..., ::up] = x
        x = stuffed
    # full correlation with the reversed taps (pad K-1 both sides), every
    # `down`-th output
    xpad = F.pad(x, (K - 1, K - 1))
    y = fir_correlate_matmul(xpad, hp[::-1].copy(), stride=down)
    return y[..., n_pre_remove:n_pre_remove + n_out]


def resample_to(x: torch.Tensor, fqs: int, target_fqs: int = 250,
                method: str = 'fft') -> torch.Tensor:
    """Resample the last axis from ``fqs`` Hz to ``target_fqs`` Hz.

    'fft' matches the reference Python export (wfdb resample_sig,
    data_export.py:205-215); 'poly' matches the MATLAB export
    (DataPreprocessor.m:45-54) and is the fast path.
    """
    if fqs == target_fqs:
        return x
    if method == 'fft':
        num = int(x.shape[-1] * target_fqs / fqs)
        return resample_fft(x, num)
    g = math.gcd(target_fqs, fqs)
    return resample_poly(x, target_fqs // g, fqs // g)
