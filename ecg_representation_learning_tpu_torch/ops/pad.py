"""Time-axis padding (reference ``TimeEndPad``, transform.py:140-154) and the
tokenizer's segment padder (``EcgPadder``, ecg_tokenizer.py:88-137)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def time_end_pad(x: torch.Tensor, k: int, value: float = 0.0) -> torch.Tensor:
    """Pad the last axis at the end up to the next multiple of ``k``.

    Quirk kept for parity: an already-aligned length is padded by a full
    extra ``k`` (n_pad = k - L % k is never 0) -- 2500 -> 2560 with k=64, and
    2560 -> 2624.
    """
    n_pad = k - (x.shape[-1] % k)
    return F.pad(x, (0, n_pad), value=value)


def pad_to_multiple(x: torch.Tensor, k: int, mode: str = 'zero') -> torch.Tensor:
    """Tokenizer segment padding (reference ``EcgPadder``,
    ecg_tokenizer.py:88-137), with the same always-pad quirk
    (``n_pad = k - L % k``, never 0).  'zero' pads with zeros; 'shift'
    repeats the last ``n_pad`` real samples (ecg_tokenizer.py:121), keeping
    the morphology at the boundary."""
    length = x.shape[-1]
    n_pad = k - (length % k)
    if mode == 'zero':
        return F.pad(x, (0, n_pad))
    if mode == 'shift':
        return torch.cat([x, x[..., length - n_pad:length]], dim=-1)
    raise ValueError(f'Unknown pad mode {mode!r}')
