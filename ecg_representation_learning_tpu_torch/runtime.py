"""Device selection.

The port runs on the GPU.  It uses the CPU only when the caller asks for it
(the tests do, with ``device='cpu'``), and never falls back to it silently:
on the CPU every kernel wrapper runs its plain PyTorch version instead.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def default_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless ``device`` names another; raises when the device
    asked for (or, with ``None``, any GPU) is not visible."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is visible to PyTorch; pass device="cpu" to run '
            'the plain PyTorch versions of the kernels on the CPU')
    if dev.type not in ('cuda', 'cpu'):
        raise RuntimeError(f'unsupported device {dev}; use "cuda" or "cpu"')
    return dev
