"""Robust LOESS (local quadratic regression) baseline-wander removal
(JAX package ``ops/loess.py``).

The reference subtracts a robust LOESS smooth with a window of ``fqs`` points
(data_preprocessor.py:44, 60-73; MATLAB ``smooth(sig, fqs, 'rloess')``):
tricube distance weights, a local quadratic fit over the ``n`` nearest points,
and bisquare robustifying iterations against the global MAD of the residuals.

Batched over (record, lead) axes, as in the JAX package:

* interior points have a fixed symmetric window, so the weighted normal
  equations reduce to eight moment sums -- FIR correlations of the robust
  weights ``r`` (and ``r*y``) with the fixed kernels ``K(u) u^k`` -- computed
  by the framed Toeplitz products of :mod:`.filter`, then a closed-form 3x3
  Cramer solve per point;
* the first and last ``half`` points use shifted windows, one small einsum
  over precomputed (edge point, window) weights;
* each robust iteration rebuilds the bisquare weights from the residuals,
  with the exact bisection median :func:`median_last_axis`.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .filter import device_const, einsum_f32, fir_correlate_matmul_multi


def _force_odd(n: int) -> int:
    """MATLAB-compatible odd forcing (reference data_preprocessor.py:15-16)."""
    return 2 * (n // 2) + 1


@functools.lru_cache(maxsize=None)
def _interior_kernels(n: int) -> np.ndarray:
    """(5, n) kernels K(u) * u^k, k=0..4, u normalized to [-1, 1]."""
    half = (n - 1) // 2
    u = np.arange(-half, half + 1) / half
    tricube = np.maximum((1.0 - np.abs(u) ** 3) ** 3, 0.0)
    return np.stack([tricube * u ** k for k in range(5)]).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _edge_geometry(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """For the ``half`` left-edge points: tricube weights and offsets.

    Returns (W, U): W[i, j] tricube weight of window point j for edge point i,
    U[i, j] normalized offset (x_j - x_i)/d_max.  The window for every edge
    point is the first n samples; d_max = max distance within it.  Right edges
    mirror.
    """
    half = (n - 1) // 2
    i = np.arange(half)[:, None]
    j = np.arange(n)[None, :]
    d = j - i
    dmax = np.maximum(i, n - 1 - i)
    u = d / dmax
    w = np.maximum(1.0 - np.abs(u) ** 3, 0.0) ** 3
    return w.astype(np.float64), u.astype(np.float64)


def _interior_smooth(y: torch.Tensor, rw: torch.Tensor, n: int,
                     eps: float = 1e-7) -> torch.Tensor:
    """LOESS values for interior points i in [half, L-half).

    y, rw: (..., L).  Returns (..., L - 2*half).  (Odd-power kernels enter
    with either sign convention: mirroring u -> -u leaves the fitted
    intercept unchanged.)
    """
    kerns = _interior_kernels(n)
    lead_shape = y.shape[:-1]
    L = y.shape[-1]
    S = fir_correlate_matmul_multi(rw.reshape(-1, L), kerns)           # (B, n_out, 5)
    T = fir_correlate_matmul_multi((rw * y).reshape(-1, L), kerns[:3])  # (B, n_out, 3)
    s0, s1, s2, s3, s4 = S.unbind(-1)
    t0, t1, t2 = T.unbind(-1)
    # Cramer's rule for [[s0,s1,s2],[s1,s2,s3],[s2,s3,s4]] beta = [t0,t1,t2]
    s0 = s0 + eps
    s2r = s2 + eps
    s4r = s4 + eps
    det = (s0 * (s2r * s4r - s3 * s3)
           - s1 * (s1 * s4r - s3 * s2)
           + s2 * (s1 * s3 - s2r * s2))
    det0 = (t0 * (s2r * s4r - s3 * s3)
            - s1 * (t1 * s4r - s3 * t2)
            + s2 * (t1 * s3 - s2r * t2))
    beta0 = det0 / torch.where(det.abs() < eps, eps, det)
    return beta0.reshape(lead_shape + (beta0.shape[-1],))


def _edge_tensors(n: int, flip: bool, like: torch.Tensor):
    def make():
        w, u = _edge_geometry(n)
        if flip:
            w, u = w[:, ::-1], -u[:, ::-1]
        return np.stack([w, u])
    w, u = device_const(('loess_edge', n, flip), like, make).unbind(0)
    return w, torch.stack([u ** k for k in range(5)])                  # (half, n), (5, half, n)


def _edge_smooth(y_win: torch.Tensor, rw_win: torch.Tensor, n: int,
                 flip: bool, eps: float = 1e-7) -> torch.Tensor:
    """LOESS values for the ``half`` points at one edge.

    y_win, rw_win: (..., n) -- the first (or last) n samples.  flip=True for
    the right edge (geometry mirrors).  Returns (..., half).
    """
    w, uk = _edge_tensors(n, flip, y_win)
    wt = w * rw_win[..., None, :]                                      # (..., half, n)
    # moments: S_k = sum_j wt * u^k ; T_k = sum_j wt * u^k * y
    S = einsum_f32('...hj,khj->k...h', wt, uk)
    T = einsum_f32('...hj,khj,...j->k...h', wt, uk[:3], y_win)
    s0, s1, s2, s3, s4 = S[0] + eps, S[1], S[2] + eps, S[3], S[4] + eps
    t0, t1, t2 = T
    det = (s0 * (s2 * s4 - s3 * s3)
           - s1 * (s1 * s4 - s3 * S[2])
           + S[2] * (s1 * s3 - s2 * S[2]))
    det0 = (t0 * (s2 * s4 - s3 * s3)
            - s1 * (t1 * s4 - s3 * t2)
            + S[2] * (t1 * s3 - s2 * t2))
    beta0 = det0 / torch.where(det.abs() < eps, eps, det)
    return beta0.flip(-1) if flip else beta0


def _smooth_once(y: torch.Tensor, rw: torch.Tensor, n: int) -> torch.Tensor:
    mid = _interior_smooth(y, rw, n)
    left = _edge_smooth(y[..., :n], rw[..., :n], n, flip=False)
    right = _edge_smooth(y[..., -n:], rw[..., -n:], n, flip=True)
    return torch.cat([left, mid, right], dim=-1)


def median_last_axis(r: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """Exact median over the last axis by bisection on counts (the JAX
    package's unrolled form, value for value).

    For the 1-based order statistic k, ``hi`` converges onto the smallest
    value t with count(r <= t) >= k: each of the ``iters`` halvings takes
    mid = 0.5 * (lo + hi) in the input's dtype and keeps the half where the
    count test holds.  Even lengths average the two middle order statistics,
    which are bisected side by side.
    """
    length = r.shape[-1]
    ks = [length // 2 + 1] if length % 2 else [length // 2, length // 2 + 1]
    k = torch.tensor(ks, device=r.device)
    shape = r.shape[:-1] + (len(ks),)
    lo = r.amin(-1, keepdim=True).expand(shape)
    hi = r.amax(-1, keepdim=True).expand(shape)
    r = r[..., None, :]
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = (r <= mid[..., None]).sum(-1) >= k
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    if length % 2:
        return hi[..., 0]
    return 0.5 * (hi[..., 0] + hi[..., 1])


def rloess(y: torch.Tensor, n: int, robust_iters: int = 5) -> torch.Tensor:
    """Robust LOESS smooth of the last axis with an ``n``-point window.

    Semantics of the reference ``DataPreprocessor.rloess`` (quadratic, window
    forced odd, data_preprocessor.py:60-73) with MATLAB 'rloess' bisquare
    robustification.  Returns the smoothed signal (the caller subtracts it).
    """
    n = _force_odd(min(n, y.shape[-1]))
    if n > y.shape[-1]:
        n -= 2  # forced-odd may overshoot an even-length signal
    if n < 5:
        return y
    rw = torch.ones_like(y)
    yhat = _smooth_once(y, rw, n)
    for _ in range(robust_iters):
        r = y - yhat
        med = median_last_axis(r)[..., None]
        mad = median_last_axis((r - med).abs())[..., None]
        scale = 6.0 * mad + 1e-12
        t = torch.clamp(r.abs() / scale, 0.0, 1.0)
        rw = (1.0 - t * t) ** 2
        yhat = _smooth_once(y, rw, n)
    return yhat


def remove_baseline(y: torch.Tensor, fqs: int = 500, robust_iters: int = 5) -> torch.Tensor:
    """``sig - rloess(sig, n=fqs)`` -- the baseline-wander removal step of the
    Zheng chain (data_preprocessor.py:44)."""
    return y - rloess(y, n=fqs, robust_iters=robust_iters)
