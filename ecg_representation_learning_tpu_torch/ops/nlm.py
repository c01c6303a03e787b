"""1-D non-local-means denoising (Darbon fast algorithm), plain PyTorch
(JAX package ``ops/nlm.py``).

Reference: ``DataPreprocessor.nlm`` / ``est_noise_std``
(data_preprocessor.py:75-148), a port of Zheng's ECGDenoisingTool and MATLAB
``nlm.m``, with its quirks:

* search shifts ``idx in [-(sch_wd-1), sch_wd-1]`` with default
  ``sch_wd = len(sig)`` (full O(L^2) search, data_preprocessor.py:98-99);
* per-shift cumulative-SSD windowed distances (Darbon Eq. 3-4);
* smoothing bandwidth ``h = 2 * (2*patch_wd+1) * (scale * sigma_est)^2``
  with the second-difference MAD noise estimate (data_preprocessor.py:75-80);
* the target-index guard ``0 < i+idx < n`` (strictly excludes index 0,
  data_preprocessor.py:140);
* edge passthrough for the first ``patch_wd+1`` and last ``patch_wd``
  samples (data_preprocessor.py:146-147);
* ``eps`` in the weight normalization (data_preprocessor.py:145).

:func:`nlm` is the shift-scan form the JAX package runs on CPU and GPU, one
pass over the signal per shift.  The denoise chain runs the fused kernel of
:mod:`.nlm_fused` instead.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .filter import fir_correlate_matmul
from .loess import median_last_axis


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r[j] = a[j] r[j-1] + b[j] along the last axis, as a log-depth
    inclusive scan over the affine maps (a, b), composed earlier-first."""
    d = 1
    while d < a.shape[-1]:
        a, b = (torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], dim=-1),
                torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], dim=-1))
        d *= 2
    return b


def est_noise_std(x: torch.Tensor) -> torch.Tensor:
    """Noise-sigma estimate, batched over leading axes.

    Matches ``DataPreprocessor.est_noise_std`` (data_preprocessor.py:75-80)
    *including its in-place update*: the loop writes ``res[i]`` using the
    already-updated ``res[i-1]``, so the semantics are the first-order linear
    recurrence  r[i] = (2 x[i] - x[i+1] - r[i-1]) / sqrt(6)  with r[0] = x[0]
    and r[n-1] = x[n-1].  Short signals (n - 1 <= 34) solve it with a
    log-depth scan; longer ones as a causal 32-tap FIR with the geometric
    kernel A^m (|A|^32 ~ 3.6e-13), through the framed product.  Then
    1.4826 * median(|res - median(res)|).  Returns shape ``x.shape[:-1]``.
    """
    s6 = np.sqrt(6.0)
    n = x.shape[-1]
    a_coef = -1.0 / s6
    # B[i] for interior i in [1, n-2]: (2 x[i] - x[i+1]) / sqrt(6); A = -1/sqrt(6)
    b = (2.0 * x[..., 1:-1] - x[..., 2:]) / s6
    # drive sequence with the seed folded in: Bfull[0] = x[0]
    bfull = torch.cat([x[..., :1], b], dim=-1)                          # length n-1
    K = 32
    if n - 1 <= K + 2:
        aa = torch.cat([torch.zeros_like(x[..., :1]), torch.full_like(b, a_coef)], dim=-1)
        r = _linear_scan(aa, bfull)
    else:
        taps = (a_coef ** np.arange(K - 1, -1, -1)).astype(np.float64)
        xp = F.pad(bfull.reshape(-1, n - 1), (K - 1, 0))
        r = fir_correlate_matmul(xp, taps).reshape(bfull.shape)
    res = torch.cat([r, x[..., -1:]], dim=-1)
    med = median_last_axis(res)[..., None]
    return 1.4826 * median_last_axis((res - med).abs())


def nlm(
    x: torch.Tensor,
    scale: float = 1.5,
    sch_wd: Optional[int] = None,
    patch_wd: int = 10,
) -> torch.Tensor:
    """Non-local-means denoise of the last axis, batched over leading axes:
    the shift-scan form, one pass per shift in [-(sch_wd-1), sch_wd-1].

    Parameters mirror the reference (data_preprocessor.py:83-99): ``scale`` the
    Gaussian smoothness factor, ``sch_wd`` the max search distance (None =
    whole signal), ``patch_wd`` the patch half-width.
    """
    n = x.shape[-1]
    if sch_wd is None:
        sch_wd = n
    sch = sch_wd - 1  # reference off-by-one convention (data_preprocessor.py:101)

    sigma = est_noise_std(x)
    h = (2.0 * (2 * patch_wd + 1) * (scale * sigma) ** 2)[..., None]

    pos = torch.arange(n, device=x.device)
    interior = (pos >= patch_wd + 1) & (pos < n - patch_wd)
    num = torch.zeros_like(x)
    z = torch.zeros_like(x)
    for s in range(-sch, sch + 1):
        # x[k+s] with out-of-range positions masked to 0
        kplus = pos + s
        in_range = (kplus >= 0) & (kplus < n)
        xs = torch.where(in_range, torch.roll(x, -s, dims=-1), 0.0)
        ssd = torch.where(in_range, (x - xs) ** 2, 0.0)
        sdx = torch.cumsum(ssd, dim=-1)
        # distance_i = sdx[i + patch_wd] - sdx[i - patch_wd - 1]; valid for interior i
        dist = torch.roll(sdx, -patch_wd, dims=-1) - torch.roll(sdx, patch_wd + 1, dims=-1)
        w = torch.exp(-dist / h)
        # reference guard: target index t = i + s must satisfy 0 < t < n
        w = torch.where(interior & (kplus > 0) & (kplus < n), w, 0.0)
        num = num + w * xs
        z = z + w
    den = num / (z + sys.float_info.epsilon)
    return torch.where(interior, den, x)
