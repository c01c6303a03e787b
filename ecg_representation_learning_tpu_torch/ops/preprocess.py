"""Fused preprocessing pipelines: the Zheng denoise chain and the fast path
(JAX package ``ops/preprocess.py``).

The reference's offline chain (data_preprocessor.py:22-45 / MATLAB
DataPreprocessor.m) runs per record per lead on the host; here it runs over
an (N, C, L) batch on the device:

    resample -> butterworth low-pass (zero-phase) -> subtract robust LOESS
    -> non-local means (the fused kernel, ``ops/csrc/nlm.cu``)

plus the online path used for training (the 'original'-type PTB-XL export):

    resample -> low-pass -> per-lead normalize -> pad-to-multiple(patch)
"""
from __future__ import annotations

import torch

from ..configs import PreprocessConfig
from .filter import butterworth_low_pass
from .loess import rloess
from .nlm_fused import nlm_fused
from .pad import time_end_pad
from .resample import resample_to


def zheng_denoise(
    x: torch.Tensor,
    fqs: int = 500,
    cfg: PreprocessConfig = PreprocessConfig(),
    lowpass_method: str = 'fir',
) -> torch.Tensor:
    """The Zheng et al. denoise chain (data_preprocessor.py:22-45), batched.

    ``x``: (..., L) at ``fqs`` Hz.  Low-pass -> subtract rloess(window=fqs) ->
    NLM, whose kernel runs for a CUDA tensor and its plain version for a CPU
    tensor.  ``cfg.nlm_search_width=None`` keeps the reference's full-signal
    search; set it (e.g. 128) for the bounded run.
    """
    y = zheng_detrend(x, fqs, cfg, lowpass_method)
    return nlm_fused(y, scale=cfg.nlm_smooth_factor, sch_wd=cfg.nlm_search_width,
                     patch_wd=cfg.nlm_patch_halfwidth)


def zheng_detrend(
    x: torch.Tensor,
    fqs: int = 500,
    cfg: PreprocessConfig = PreprocessConfig(),
    lowpass_method: str = 'fir',
) -> torch.Tensor:
    """The chain's first two steps, the NLM step's input: low-pass, then
    subtract the robust LOESS smooth."""
    y = butterworth_low_pass(
        x, fs=fqs,
        passband=cfg.lowpass_passband, stopband=cfg.lowpass_stopband,
        ripple_db=cfg.lowpass_ripple_db, attenuation_db=cfg.lowpass_attenuation_db,
        method=lowpass_method,
    )
    window = cfg.loess_window or fqs
    return y - rloess(y, n=window, robust_iters=cfg.loess_robust_iters)


def fused_export(
    x: torch.Tensor,
    fqs: int = 500,
    cfg: PreprocessConfig = PreprocessConfig(),
    denoise: bool = True,
) -> torch.Tensor:
    """Offline export step: resample to the 250 Hz grid, optionally denoise
    (data_export.py:205-215 resample + the MATLAB denoise pass,
    DataExport.m:38-43)."""
    y = resample_to(x, fqs, cfg.target_fqs, method='poly')
    if denoise:
        y = zheng_denoise(y, fqs=cfg.target_fqs, cfg=cfg)
    return y


def fused_train_path(
    x: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    fqs: int = 500,
    target_fqs: int = 250,
    patch_size: int = 64,
    lowpass: bool = True,
) -> torch.Tensor:
    """The online fast path: resample + (optional) low-pass + z-norm + window:
    raw (N, 12, L@fqs) records to normalized, patch-aligned (N, 12, L'@250)
    training inputs.  ``mean``/``std``: per-lead statistics."""
    y = resample_to(x, fqs, target_fqs, method='poly')
    if lowpass:
        y = butterworth_low_pass(y, fs=target_fqs, method='fir')
    y = (y - mean.reshape(-1, 1)) / std.reshape(-1, 1)
    return time_end_pad(y, patch_size)
