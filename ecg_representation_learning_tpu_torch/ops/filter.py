"""Zero-phase Butterworth low-pass filtering (JAX package ``ops/filter.py``).

The reference applies ``scipy.signal.filtfilt`` with a Butterworth low-pass
designed by ``buttord``/``butter`` (data_preprocessor.py:47-58; passband 50 Hz,
stopband 60 Hz, 1 dB ripple, 2.5 dB attenuation).  Two paths over the same
host-side design, as in the JAX package:

1. ``filtfilt_scan``: exact ``scipy.signal.filtfilt`` semantics (odd extension,
   ``lfilter_zi`` initial conditions, forward and backward pass), with the IIR
   recurrence as a Python loop over time on a (..., order) state.  The golden
   path; the main path reaches it only for signals shorter than the FIR edge.
2. ``filtfilt_fir``: the symmetric FIR ``g = h * reverse(h)`` of filtfilt,
   truncated on the host, applied as a framed Toeplitz matrix product
   (:func:`fir_correlate_matmul`).

The framed products are plain large matrix products, computed with
``torch.matmul`` in true float32 (the JAX package pins ``Precision.HIGHEST``;
here TF32 is switched off around each product).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Host-side filter design (small, static; runs once per (fs, band) config)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def butter_lowpass_design(
    fs: float = 500.0,
    passband: float = 50.0,
    stopband: float = 60.0,
    ripple_db: float = 1.0,
    attenuation_db: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Butterworth low-pass (b, a) via buttord/butter (reference data_preprocessor.py:56-58)."""
    from scipy import signal
    nyq = 0.5 * fs
    order, wn = signal.buttord(passband / nyq, stopband / nyq, ripple_db, attenuation_db)
    b, a = signal.butter(order, wn, btype='low')
    return np.asarray(b, np.float64), np.asarray(a, np.float64)


@functools.lru_cache(maxsize=None)
def _lfilter_zi(b: Tuple[float, ...], a: Tuple[float, ...]) -> np.ndarray:
    from scipy import signal
    return signal.lfilter_zi(np.asarray(b), np.asarray(a))


@functools.lru_cache(maxsize=None)
def filtfilt_fir_taps(
    b: Tuple[float, ...], a: Tuple[float, ...], tol: float = 1e-8, max_len: int = 4096
) -> np.ndarray:
    """Symmetric FIR equivalent of filtfilt: g = h (*) reverse(h), h truncated at |h|<tol.

    Host-side, cached per filter design.  Returns an odd-length float64 kernel.
    """
    from scipy import signal
    bb, aa = np.asarray(b), np.asarray(a)
    imp = np.zeros(max_len)
    imp[0] = 1.0
    h = signal.lfilter(bb, aa, imp)
    mag = np.abs(h)
    keep = np.nonzero(mag > tol * mag.max())[0]
    k = int(keep[-1]) + 1 if keep.size else 1
    h = h[:k]
    g = np.convolve(h, h[::-1])  # length 2k-1, symmetric, zero-phase
    return g.astype(np.float64)


# ---------------------------------------------------------------------------
# Device-side pieces
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _ieee_f32():
    """Full float32 products on the GPU (no TF32) for the enclosed calls."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with TF32 off: the JAX package's ``Precision.HIGHEST``."""
    with _ieee_f32():
        return torch.einsum(eq, *operands)


_CONSTS: dict = {}


def device_const(key, like: torch.Tensor, make) -> torch.Tensor:
    """``make()`` (a numpy array) as a tensor on ``like``'s device and dtype,
    built once per ``key``: a chunk of the denoise chain uses the same tap
    matrices a dozen times (the LOESS one is 2.6 MB), and a chunk loop would
    otherwise rebuild and copy them to the device on every call.  Keys are
    filter designs, a handful per configuration."""
    k = (key, str(like.device), like.dtype)
    if k not in _CONSTS:
        _CONSTS[k] = torch.as_tensor(make(), dtype=like.dtype, device=like.device)
    return _CONSTS[k]


def odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension along the last axis (scipy.signal.odd_ext semantics)."""
    left = 2 * x[..., :1] - x[..., 1:n + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -n - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def lfilter(b, a, x: torch.Tensor, zi: torch.Tensor = None) -> torch.Tensor:
    """IIR filter along the last axis, direct form II transposed, one step
    per sample.  ``x``: (..., L); ``zi``: (..., order) initial conditions or
    None for zeros.  Matches ``scipy.signal.lfilter``."""
    b = torch.as_tensor(np.asarray(b), dtype=x.dtype, device=x.device)
    a = torch.as_tensor(np.asarray(a), dtype=x.dtype, device=x.device)
    order = b.shape[0] - 1
    z = torch.zeros(x.shape[:-1] + (order,), dtype=x.dtype, device=x.device) if zi is None else zi
    zero = torch.zeros_like(z[..., :1])
    ys = []
    for n in range(x.shape[-1]):
        xn = x[..., n]
        #   y = b0*x + z[0];  z[k] = b[k+1]*x + z[k+1] - a[k+1]*y  (z[order] = 0)
        yn = b[0] * xn + z[..., 0]
        z_shift = torch.cat([z[..., 1:], zero], dim=-1)
        z = b[1:] * xn[..., None] + z_shift - a[1:] * yn[..., None]
        ys.append(yn)
    return torch.stack(ys, dim=-1)


def filtfilt_scan(b, a, x: torch.Tensor, padlen: int = None) -> torch.Tensor:
    """Exact scipy.signal.filtfilt: odd padding + zi-initialized forward/backward IIR.

    ``x``: (..., L) float tensor.  b, a: host numpy design from
    :func:`butter_lowpass_design`.
    """
    b = np.asarray(b)
    a = np.asarray(a)
    if padlen is None:
        padlen = 3 * max(len(a), len(b))  # scipy default
    padlen = min(padlen, x.shape[-1] - 1)  # short signals: cap the extension
    zi = _lfilter_zi(tuple(b.tolist()), tuple(a.tolist()))
    zi_t = torch.as_tensor(zi, dtype=x.dtype, device=x.device)

    ext = odd_ext(x, padlen)
    y = lfilter(b, a, ext, zi=zi_t * ext[..., :1])
    y = y.flip(-1)
    y = lfilter(b, a, y, zi=zi_t * y[..., :1])
    y = y.flip(-1)
    return y[..., padlen:-padlen]


def _frames(x: torch.Tensor, n_blk: int, window: int, step: int) -> torch.Tensor:
    """(..., n_blk, window) overlapping frames starting every ``step``
    samples, the signal zero-padded at the end as far as they reach."""
    need = (n_blk - 1) * step + window
    xp = F.pad(x, (0, max(need - x.shape[-1], 0)))
    return xp.unfold(-1, window, step)[..., :n_blk, :]


def _toeplitz(taps: Tuple[float, ...], stride: int, block: int) -> np.ndarray:
    """Banded tap matrix T[w, j] = h[w - j*stride] where 0 <= w - j*stride < K."""
    taps = np.asarray(taps)
    K = len(taps)
    window = (block - 1) * stride + K
    d = np.arange(window)[:, None] - np.arange(block)[None, :] * stride
    return np.where((d >= 0) & (d < K), taps[np.clip(d, 0, K - 1)], 0.0)


def fir_correlate_matmul(x: torch.Tensor, taps: np.ndarray, stride: int = 1,
                         block: int = 256) -> torch.Tensor:
    """Valid-mode FIR correlation ``y[n] = sum_k h[k] x[n*stride + k]`` as a
    framed Toeplitz product: the signal cut into overlapping windows, each
    contracted against a (window x block) banded tap matrix.

    ``x``: (..., L).  Output length: (L - K) // stride + 1.
    """
    taps = tuple(np.asarray(taps, np.float64).tolist())
    K = len(taps)
    n_out = (x.shape[-1] - K) // stride + 1
    n_blk = -(-n_out // block)
    window = (block - 1) * stride + K
    frames = _frames(x, n_blk, window, block * stride)             # (..., n_blk, W)
    T = device_const(('toeplitz', taps, stride, block), x,
                     lambda: _toeplitz(taps, stride, block))
    with _ieee_f32():
        out = torch.matmul(frames, T)                                # (..., n_blk, block)
    return out.reshape(x.shape[:-1] + (n_blk * block,))[..., :n_out]


def _toeplitz_multi(taps: Tuple[Tuple[float, ...], ...], block: int) -> np.ndarray:
    taps = np.asarray(taps)
    K = taps.shape[1]
    window = block - 1 + K
    d = np.arange(window)[:, None] - np.arange(block)[None, :]      # (W, block)
    valid = (d >= 0) & (d < K)
    return np.where(valid[..., None], taps.T[np.clip(d, 0, K - 1)], 0.0)  # (W, block, M)


def fir_correlate_matmul_multi(x: torch.Tensor, taps: np.ndarray,
                               block: int = 256) -> torch.Tensor:
    """Valid-mode correlation against M tap vectors at once:
    ``y[n, m] = sum_k taps[m, k] x[n + k]``, one product against an
    (window, block, M) banded tensor.  ``x``: (..., L); returns
    (..., n_out, M) with n_out = L - K + 1.
    """
    taps = tuple(tuple(row) for row in np.asarray(taps, np.float64).tolist())
    M, K = len(taps), len(taps[0])
    n_out = x.shape[-1] - K + 1
    n_blk = -(-n_out // block)
    window = block - 1 + K
    frames = _frames(x, n_blk, window, block)                       # (..., n_blk, W)
    T = device_const(('toeplitz_multi', taps, block), x,
                     lambda: _toeplitz_multi(taps, block).reshape(window, block * M))
    with _ieee_f32():
        out = torch.matmul(frames, T)                                # (..., n_blk, block*M)
    out = out.reshape(x.shape[:-1] + (n_blk * block, M))
    return out[..., :n_out, :]


def filtfilt_fir(b, a, x: torch.Tensor, tol: float = 1e-8) -> torch.Tensor:
    """Fast zero-phase filter: the symmetric-FIR surrogate applied as a framed
    Toeplitz product (see :func:`fir_correlate_matmul`), with the same odd
    extension at the edges.  Equivalent to filtfilt up to the IIR-tail
    truncation of :func:`filtfilt_fir_taps`."""
    b = np.asarray(b)
    a = np.asarray(a)
    g = filtfilt_fir_taps(tuple(b.tolist()), tuple(a.tolist()), tol)
    halfw = (len(g) - 1) // 2
    padlen = max(3 * max(len(a), len(b)), halfw)
    if padlen >= x.shape[-1]:
        # signal shorter than the FIR edge region: the exact scan path, which
        # caps its own extension
        return filtfilt_scan(b, a, x)
    ext = odd_ext(x, padlen)
    # y[n] = sum_j g[j] ext[n + j]; want out[m] = y[m + padlen - halfw], m in [0, L)
    full = fir_correlate_matmul(ext, g, stride=1)
    start = padlen - halfw
    return full[..., start:start + x.shape[-1]]


def butterworth_low_pass(
    x: torch.Tensor,
    fs: float = 500.0,
    passband: float = 50.0,
    stopband: float = 60.0,
    ripple_db: float = 1.0,
    attenuation_db: float = 2.5,
    method: str = 'fir',
) -> torch.Tensor:
    """The reference's ``DataPreprocessor.butterworth_low_pass`` (data_preprocessor.py:47-58),
    batched over leading axes.  ``method``: 'fir' (the framed product) or 'scan' (exact IIR)."""
    b, a = butter_lowpass_design(fs, passband, stopband, ripple_db, attenuation_db)
    if method == 'scan':
        return filtfilt_scan(b, a, x)
    return filtfilt_fir(b, a, x)
