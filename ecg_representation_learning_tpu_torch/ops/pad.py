"""Time-axis padding (reference ``TimeEndPad``, transform.py:140-154)."""
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
