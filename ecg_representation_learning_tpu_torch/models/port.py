"""Weights between the JAX package's flax ``EcgVit`` and the port's.

The flax tree (``{'params': {'encoder': {...}, 'head': {...}}}``, unrolled
``block_i`` layout, numpy leaves) and the port's ``state_dict`` name the same
modules, so the mapping is by path:

  * ``block_i`` <-> ``blocks.i`` (an ``nn.ModuleList``);
  * a Dense ``kernel`` (in, out) <-> a Linear ``weight`` (out, in), transposed;
  * a LayerNorm ``scale`` <-> ``weight``; ``bias``, ``cls_token`` and
    ``pos_embed`` carry over as they are (``qkv`` has no bias).

Both directions copy values exactly, so flax -> torch -> flax is bit-exact.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs import VitConfig
from .vit import EcgVit


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _torch_key(path) -> str:
    parts = []
    for p in path:
        if p.startswith('block_'):
            parts += ['blocks', p[len('block_'):]]
        else:
            parts.append({'kernel': 'weight', 'scale': 'weight'}.get(p, p))
    return '.'.join(parts)


def vit_state_dict_from_flax(params: Mapping, cfg: VitConfig) -> Dict[str, torch.Tensor]:
    """flax ``EcgVit`` params -> the port's ``EcgVit`` state_dict.

    Raises ``KeyError`` on a missing or unexpected key and ``ValueError`` on
    a shape mismatch, so a partial mapping cannot pass silently."""
    tree = params['params'] if 'params' in params else params
    want = EcgVit(cfg).state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if path[-1] == 'kernel':
            arr = arr.T
        key = _torch_key(path)
        if key not in want:
            raise KeyError(f'flax param {"/".join(path)} maps to {key}, '
                           f'which the port has no parameter for')
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f'{key}: expected shape {tuple(want[key].shape)}, '
                             f'got {arr.shape}')
        out[key] = torch.from_numpy(np.array(arr, copy=True, order='C'))
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f'flax params lack {missing}')
    return out


def flax_params_from_vit_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`vit_state_dict_from_flax`: the port's state_dict ->
    ``{'params': ...}`` with numpy leaves.  A 2-D ``weight`` is a Linear's
    (a Dense ``kernel``), a 1-D one a LayerNorm's ``scale``."""
    tree: Dict = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy()
        parts = key.split('.')
        path = []
        i = 0
        while i < len(parts):
            if parts[i] == 'blocks':
                path.append(f'block_{parts[i + 1]}')
                i += 2
            else:
                path.append(parts[i])
                i += 1
        if path[-1] == 'weight':
            if arr.ndim == 2:
                path[-1], arr = 'kernel', arr.T
            else:
                path[-1] = 'scale'
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {'params': tree}
