"""Enumerated-argument validation (the JAX package's ``ca``, for the categories
the ported entry points take)."""
from __future__ import annotations

from typing import Dict, Sequence

from ..configs import VitConfig
from ..registry import PTBXL_TRAIN_STATS


class CheckArg:
    """``ca(model_size='base')``-style keyword validation."""

    def __init__(self):
        self.d_name2accepted: Dict[str, Sequence[str]] = {}
        self.cache_mismatch('model_name',
                            [f'ecg-vit-{s}' for s in VitConfig._SIZES])
        self.cache_mismatch('model_size', list(VitConfig._SIZES))
        self.cache_mismatch('ptbxl_type', list(PTBXL_TRAIN_STATS))
        self.cache_mismatch('loss_reduction', ['mean', 'none'])
        self.cache_mismatch('optimizer', ['AdamW', 'Adam'])
        self.cache_mismatch('schedule', ['constant', 'cosine'])

    def cache_mismatch(self, name: str, accepted: Sequence[str]):
        self.d_name2accepted[name] = list(accepted)

    def check_mismatch(self, display_name: str, value, accepted: Sequence[str]):
        if value not in accepted:
            raise ValueError(
                f'Unexpected {display_name}: expected one of {sorted(accepted)}, '
                f'got {value!r}')

    def __call__(self, **kwargs):
        for name, value in kwargs.items():
            if name not in self.d_name2accepted:
                raise ValueError(f'Unknown argument category {name!r}; known: '
                                 f'{sorted(self.d_name2accepted)}')
            self.check_mismatch(name, value, self.d_name2accepted[name])


ca = CheckArg()
