"""Plain reference of the streaming input path, in NumPy and SciPy (float64):
wire decode, resampling to 250 Hz, the zero-phase Butterworth low-pass,
per-lead z-normalization, the pad to a patch multiple and the crop to the
model's input.  Imports nothing of the program under test.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import signal

TARGET_FQS = 250
# the configurations' low-pass: 50 Hz passband, 60 Hz stopband, 1 dB ripple,
# 2.5 dB attenuation, applied forward and backward
LOWPASS = (50.0, 60.0, 1.0, 2.5)


def model_input(counts: np.ndarray, fqs: int, wire_scale: float, stats: dict, patch: int,
                max_len: int) -> np.ndarray:
    """(B, C, L) int16 counts at ``fqs`` Hz -> the model's (B, C, max_len)
    input on the 250 Hz grid."""
    x = counts.astype(np.float64) / wire_scale
    if fqs != TARGET_FQS:
        g = math.gcd(TARGET_FQS, fqs)
        x = signal.resample_poly(x, TARGET_FQS // g, fqs // g, axis=-1)
    nyq = 0.5 * TARGET_FQS
    order, wn = signal.buttord(LOWPASS[0] / nyq, LOWPASS[1] / nyq, LOWPASS[2], LOWPASS[3])
    b, a = signal.butter(order, wn, btype='low')
    x = signal.filtfilt(b, a, x, axis=-1)
    x = (x - np.asarray(stats['mean'])[:, None]) / np.asarray(stats['std'])[:, None]
    x = np.pad(x, [(0, 0), (0, 0), (0, patch - x.shape[-1] % patch)])
    return x[..., :max_len]
