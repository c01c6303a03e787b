"""Splits as ``torch.utils.data.Dataset``s (the JAX package's
``data/torch_adapter.py``).

For users coming from the reference (whose ``EcgDataset``/``PtbxlDataset``
return torch tensors, dataset.py:92-99, ptb_dataset.py:73-77): wraps a
:class:`~..train.trainer.SplitData` into a map-style Dataset yielding the
reference's ``{'sample_values', 'labels'}`` dict, with the same
normalize/pad/TimeOut transform options applied on the host.  The trainers
do not use it; it is an adapter for ``torch.utils.data.DataLoader``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.data import Dataset


class TorchPtbxlDataset(Dataset):
    """Map-style dataset over a split: normalize (``mean``/``std``), pad by a
    FULL extra patch when the length is already a multiple of
    ``pad_to_multiple`` (the reference quirk, kept), TimeOut (``timeout``)
    from a host generator seeded with ``seed``."""

    def __init__(self, split, mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None,
                 pad_to_multiple: Optional[int] = 64,
                 timeout: bool = False, seed: int = 77):
        self.split = split
        self.mean = None if mean is None else np.asarray(mean, np.float32).reshape(-1, 1)
        self.std = None if std is None else np.asarray(std, np.float32).reshape(-1, 1)
        self.pad = pad_to_multiple
        self.timeout = timeout
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.split)

    def __getitem__(self, idx):
        sig = np.asarray(self.split.signals[idx], np.float32)
        if self.mean is not None:
            sig = (sig - self.mean) / self.std
        if self.pad:
            n_pad = self.pad - (sig.shape[-1] % self.pad)  # reference quirk kept
            sig = np.pad(sig, [(0, 0)] * (sig.ndim - 1) + [(0, n_pad)])
        if self.timeout:
            frac = self.rng.uniform(0.0, 0.5)
            span = round(frac * sig.shape[-1])
            if span:
                start = int(self.rng.integers(0, sig.shape[-1] - span))
                sig[..., start:start + span] = 0
        return {
            'sample_values': torch.from_numpy(sig),
            'labels': torch.from_numpy(np.asarray(self.split.labels[idx], np.float32)),
        }


def as_torch_dataset(split, **kwargs) -> TorchPtbxlDataset:
    return TorchPtbxlDataset(split, **kwargs)
