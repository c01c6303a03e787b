"""ECG domain utilities: R-peak refinement, power-law fit, goodness-of-fit
(the JAX package's ``utils/ecg_domain.py``, host numpy).

Reference util/ecg.py:90-161: ``r2``, ``fit_power_law`` (scipy curve-fit of
y = a x^b), ``refine_rpeak`` (wfdb.processing.correct_peaks: snap tentative
R-peak indices to the local extremum within a +/- window).  ``wfdb`` is
not a dependency, so peak correction is implemented directly (numpy).
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np


def r2(y: np.ndarray, y_fit: np.ndarray) -> float:
    """Coefficient of determination (reference ecg.py:90-91)."""
    y = np.asarray(y, float)
    y_fit = np.asarray(y_fit, float)
    return float(1 - np.square(y - y_fit).sum() / np.square(y - y.mean()).sum())


def fit_power_law(x, y, return_fit: Union[int, bool] = False):
    """Fit y = a * x^b (reference ecg.py:95-112, scipy curve_fit)."""
    from scipy import optimize
    x = np.asarray(x, float)
    y = np.asarray(y, float)

    def pow_law(x_, a, b):
        return a * np.power(x_, b)

    (a_, b_), _ = optimize.curve_fit(pow_law, x, y, p0=(x[0] * 2, -1))
    ret = (a_, b_)
    if return_fit:
        scale = 1 if return_fit is True else int(return_fit)
        x_plot = np.linspace(x.min(), x.max(), num=x.size * scale)
        ret = ret, (x_plot, pow_law(x_plot, a_, b_))
    return ret


def correct_peaks(sig: np.ndarray, peak_inds: np.ndarray, search_radius: int,
                  smooth_window_size: int = 2, peak_dir: str = 'up') -> np.ndarray:
    """Snap tentative peak indices to the local optimum within +/- radius
    (wfdb.processing.correct_peaks semantics: compare the raw signal against
    a moving-average smoothed version and shift each peak to the max/min of
    (sig - smooth) in its window)."""
    sig = np.asarray(sig, float)
    n = sig.size
    w = max(int(smooth_window_size), 1)
    kernel = np.ones(w) / w
    smooth = np.convolve(sig, kernel, mode='same')
    resid = sig - smooth
    out = np.empty(len(peak_inds), np.int64)
    for i, p in enumerate(np.asarray(peak_inds, np.int64)):
        lo = max(p - search_radius, 0)
        hi = min(p + search_radius + 1, n)
        seg = resid[lo:hi]
        if peak_dir == 'up':
            out[i] = lo + int(np.argmax(seg))
        elif peak_dir == 'down':
            out[i] = lo + int(np.argmin(seg))
        else:  # 'both': strongest magnitude
            out[i] = lo + int(np.argmax(np.abs(seg)))
    return out


def refine_rpeak(sig: np.ndarray, idxs_peak: np.ndarray, fqs: int,
                 r_wd: int = 100) -> np.ndarray:
    """Refine tentative R-peak indices (reference refine_rpeak, ecg.py:148-161):
    search +/- ``r_wd`` milliseconds around each tentative index."""
    return correct_peaks(sig, idxs_peak,
                         search_radius=math.ceil(fqs * r_wd / 1e3),
                         smooth_window_size=2, peak_dir='up')


def detect_rpeaks(sig: np.ndarray, fqs: int, min_rr_ms: int = 300) -> np.ndarray:
    """Simple amplitude-threshold QRS detector (new convenience: the reference
    only *refines* externally-detected peaks).  Thresholds the derivative
    energy and enforces a refractory period."""
    sig = np.asarray(sig, float)
    d = np.gradient(sig)
    energy = d * d
    w = max(int(fqs * 0.05), 1)
    kernel = np.ones(w) / w
    env = np.convolve(energy, kernel, mode='same')
    th = env.mean() + 2.0 * env.std()
    cand = np.nonzero(env > th)[0]
    if cand.size == 0:
        return cand
    min_gap = int(fqs * min_rr_ms / 1e3)
    peaks = [int(cand[0])]
    for c in cand[1:]:
        if c - peaks[-1] >= min_gap:
            peaks.append(int(c))
    return refine_rpeak(sig, np.asarray(peaks), fqs)
