"""Weights between the JAX package's flax models and the port's.

The flax trees (``{'params': {...}}``, unrolled ``block_i`` layout, numpy
leaves) and the port's ``state_dict``s name the same modules, so the mapping
is by path, for ``EcgVit``, ``EcgMae`` and ``EcgContrastive`` alike:

  * ``block_i`` <-> ``blocks.i`` and ``encoder_block_i`` <->
    ``encoder_blocks.i`` (``nn.ModuleList``s);
  * a Dense ``kernel`` (in, out) <-> a Linear ``weight`` (out, in), transposed;
  * a LayerNorm ``scale`` <-> ``weight``; biases, tokens and position
    embeddings carry over as they are (``qkv`` has no bias).

Both directions copy values exactly, so flax -> torch -> flax is bit-exact.
``fused_adamw_state_from_flax`` maps the JAX ``FusedAdamWState`` (count, mu
and nu trees shaped like the params) onto the port's optimizer state the
same way, so both sides can continue from one mid-run state.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..configs import VitConfig
from ..train.optim import FusedAdamWState
from .vit import EcgVit


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


_FLAX_BLOCK = re.compile(r'(.*)block_(\d+)')


def _torch_key(path) -> str:
    parts = []
    for p in path:
        m = _FLAX_BLOCK.fullmatch(p)
        if m:
            parts += [f'{m.group(1)}blocks', m.group(2)]
        else:
            parts.append({'kernel': 'weight', 'scale': 'weight'}.get(p, p))
    return '.'.join(parts)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A torch copy of ``arr``; bfloat16 (ml_dtypes) goes through f32, exactly."""
    if arr.dtype.name == 'bfloat16':
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True, order='C'))


def state_dict_from_flax(params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """flax params -> a state_dict for ``model`` (an instance of the port's
    counterpart; its parameters are only read for their names and shapes).

    Raises ``KeyError`` on a missing or unexpected key and ``ValueError`` on
    a shape mismatch, so a partial mapping cannot pass silently."""
    tree = params['params'] if 'params' in params else params
    want = model.state_dict()
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
        out[key] = _tensor(arr)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f'flax params lack {missing}')
    return out


def vit_state_dict_from_flax(params: Mapping, cfg: VitConfig) -> Dict[str, torch.Tensor]:
    """flax ``EcgVit`` params -> the port's ``EcgVit`` state_dict."""
    with torch.device('meta'):
        model = EcgVit(cfg)
    return state_dict_from_flax(params, model)


def flax_params_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`state_dict_from_flax`: a state_dict of the port's
    ``EcgVit``, ``EcgMae`` or ``EcgContrastive`` -> ``{'params': ...}`` with
    numpy leaves.  A 2-D ``weight`` is a Linear's (a Dense ``kernel``), a 1-D
    one a LayerNorm's ``scale``."""
    tree: Dict = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy()
        parts = key.split('.')
        path = []
        i = 0
        while i < len(parts):
            if parts[i].endswith('blocks') and i + 1 < len(parts) and parts[i + 1].isdigit():
                path.append(f'{parts[i][:-len("blocks")]}block_{parts[i + 1]}')
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


def fused_adamw_state_from_flax(opt_state, cfg: VitConfig) -> FusedAdamWState:
    """The JAX ``FusedAdamWState(count, mu, nu)`` -> the port's optimizer
    state: moments keyed by the port's parameter names (Dense kernels
    transposed, as the params), their dtypes kept (bf16 mu stays bf16), and
    the count as an int."""
    return FusedAdamWState(count=int(np.asarray(opt_state.count)),
                           mu=vit_state_dict_from_flax(opt_state.mu, cfg),
                           nu=vit_state_dict_from_flax(opt_state.nu, cfg))
