"""The denoise export job: combined HDF5 -> denoised HDF5 (JAX package
``data/export.py::export_denoised``).

The MATLAB batch-denoise driver (DataExport.m:12-66) as a checkpointed device
job: RESUMABLE by skipping rows already nonzero in the output
(DataExport.m:28-44), with the broken-record rule: an all-zero input lead
stays all-zero instead of becoming NaN (record 12722's lead 11,
DataExport.m:46-54).  ``denoise_chunk`` is the per-chunk body on numpy
arrays; ``h5py`` is imported only by ``export_denoised``.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Union

import numpy as np
import torch

from ..configs import PreprocessConfig
from ..ops.preprocess import zheng_denoise
from ..runtime import default_device
from ..utils.logging import get_logger


def denoise_chunk(chunk: np.ndarray, fqs: int, cfg: PreprocessConfig = PreprocessConfig(),
                  device: Optional[Union[str, torch.device]] = None) -> np.ndarray:
    """Denoise (B, C, L) records at ``fqs`` Hz on ``device`` (default: the
    GPU): the Zheng chain, then all-zero input leads back to all zeros, then
    ``nan_to_num``.  Returns float32 numpy."""
    chunk = np.ascontiguousarray(chunk, np.float32)
    x = torch.from_numpy(chunk).to(default_device(device))
    den = zheng_denoise(x, fqs=fqs, cfg=cfg).cpu().numpy()
    zero_leads = ~np.any(chunk != 0, axis=-1)                  # (B, C)
    den = np.where(zero_leads[..., None], 0.0, den)
    return np.nan_to_num(den)


def export_denoised(
    combined_path: str,
    out_path: Optional[str] = None,
    cfg: PreprocessConfig = PreprocessConfig(),
    batch: int = 64,
    resume: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Combined -> denoised HDF5 via the device Zheng chain; resumable."""
    import h5py
    logger = get_logger('ECG Denoise Export')
    if out_path is None:
        if '-combined' in combined_path:
            out_path = combined_path.replace('-combined', '-denoised')
        else:
            base, ext = os.path.splitext(combined_path)
            out_path = f'{base}-denoised{ext}'
    if os.path.abspath(out_path) == os.path.abspath(combined_path):
        raise ValueError(f'the denoised output would overwrite its input {combined_path}')
    with h5py.File(combined_path, 'r') as src:
        data = src['data']
        attrs = json.loads(src.attrs['meta'])
        n, c, length = data.shape
        fqs = attrs['fqs']
        mode = 'r+' if (resume and os.path.exists(out_path)) else 'w'
        with h5py.File(out_path, mode) as dst:
            if 'data' not in dst:
                dst.create_dataset('data', shape=(n, c, length), dtype=np.float32)
                dst.attrs['meta'] = json.dumps({**attrs, 'denoised': True})
            out = dst['data']
            for i0 in range(0, n, batch):
                i1 = min(i0 + batch, n)
                if resume:  # skip rows already denoised (DataExport.m:28-44)
                    existing = out[i0:i1]
                    todo = ~np.any(existing != 0, axis=(1, 2))
                    if not todo.any():
                        continue
                else:
                    todo = np.ones(i1 - i0, bool)
                den = denoise_chunk(data[i0:i1], fqs, cfg, device)
                out[i0:i1] = np.where(todo[:, None, None], den, out[i0:i1])
                logger.info(f'denoised rows [{i0}, {i1})')
    return out_path
