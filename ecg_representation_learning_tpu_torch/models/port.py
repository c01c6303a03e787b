"""Weights between the JAX package's flax models and the port's.

The flax trees (``{'params': {...}}``, numpy leaves) and the port's
``state_dict``s name the same modules, so the mapping is by path, for
``EcgVit``, ``EcgMae`` and ``EcgContrastive`` alike:

  * ``block_i`` <-> ``blocks.i`` and ``encoder_block_i`` <->
    ``encoder_blocks.i`` (``nn.ModuleList``s); the ``scan_blocks`` tree's
    stacked ``blocks`` <-> the port's ``blocks`` (``ScannedBlocks``), the
    leading (L,) axis kept;
  * a Dense ``kernel`` (..., in, out) <-> a Linear ``weight`` (..., out,
    in), its last two axes swapped (the MoE router's included);
  * a LayerNorm ``scale`` <-> ``weight``; biases, tokens, position
    embeddings and the MoE expert stacks ``moe/{w1, b1, w2, b2}`` carry over
    as they are, in the JAX layout (``qkv`` has no bias).

Both directions copy values exactly, so flax -> torch -> flax is bit-exact.
``fused_adamw_state_from_flax`` maps the JAX ``FusedAdamWState`` (count, mu
and nu trees shaped like the params) onto the port's optimizer state the
same way, so both sides can continue from one mid-run state.

The reference's published checkpoints are ``state_dict``s of its wrapper
around ``vit_pytorch.ViT`` 0.33.2 (reference models/ecg_vit.py:95-161).
``port_vit_pytorch_state_dict`` maps one onto the port's ``EcgVit`` in two
steps, through the flax tree: the JAX package's numpy mapping (copied here
as ``vit_pytorch_to_flax``), then ``vit_state_dict_from_flax``, so both
routes into the port's ``state_dict`` share one mapping.  The vit-pytorch
layout (keys as stored; the wrapper prefixes them ``vit.``):

    to_patch_embedding.1.{weight,bias}      Rearrange -> Linear(patch_dim, dim)
    pos_embedding                           (1, n_patches+1, dim)
    cls_token                               (1, 1, dim)
    transformer.layers.{i}.0.norm.{w,b}     PreNorm LN before attention
    transformer.layers.{i}.0.fn.to_qkv.weight      (3*inner, dim), no bias
    transformer.layers.{i}.0.fn.to_out.0.{w,b}     (dim, inner)
    transformer.layers.{i}.1.norm.{w,b}     PreNorm LN before the MLP
    transformer.layers.{i}.1.fn.net.0.{w,b}        Linear(dim, mlp_dim)
    transformer.layers.{i}.1.fn.net.3.{w,b}        Linear(mlp_dim, dim)
    mlp_head.0.{weight,bias}                LayerNorm(dim)
    mlp_head.1.{weight,bias}                Linear(dim, num_classes)

  * vit-pytorch's Rearrange ``b c (h p1) (w p2) -> b (h w) (p1 p2 c)`` with
    h = p1 = 1 orders each patch vector time-major / channel-minor; the
    port's ``PatchEmbed1D`` orders it channel-major / time-minor, so the
    patch projection weight is permuted, not just transposed;
  * 0.33.2 has no LayerNorms around the patch projection, so the target
    ``VitConfig`` must set ``patch_norm=False`` (``reference_vit_config``);
  * with cls pooling, ``mlp_head.0`` (a LayerNorm after pooling) equals the
    port's pre-pool ``final_norm``; ``mlp_head.1`` becomes ``head``;
  * the qkv columns are q|k|v blocks, head-major within a block, on both
    sides: a plain transpose.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Tuple

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


def flax_tree_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (``{'params': ...}`` or the bare tree, numpy leaves) ->
    the port's state_dict by path alone, with no model to check it against:
    a template-free restore of any of the JAX package's models (the ViT, the
    MAE, the contrastive model, ``EcgMim``, the scan-stacked ViT)."""
    tree = params['params'] if 'params' in params else params
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if path[-1] == 'kernel':
            arr = np.swapaxes(arr, -1, -2)
        out[_torch_key(path)] = _tensor(arr)
    return out


def state_dict_from_flax(params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """flax params -> a state_dict for ``model`` (an instance of the port's
    counterpart; its parameters are only read for their names and shapes).

    Raises ``KeyError`` on a missing or unexpected key and ``ValueError`` on
    a shape mismatch, so a partial mapping cannot pass silently."""
    want = model.state_dict()
    out = flax_tree_to_state_dict(params)
    for key, val in out.items():
        if key not in want:
            raise KeyError(f'flax param {"/".join(flax_path(key))} maps to {key}, '
                           f'which the port has no parameter for')
        if tuple(val.shape) != tuple(want[key].shape):
            raise ValueError(f'{key}: expected shape {tuple(want[key].shape)}, '
                             f'got {tuple(val.shape)}')
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f'flax params lack {missing}')
    return out


def vit_state_dict_from_flax(params: Mapping, cfg: VitConfig) -> Dict[str, torch.Tensor]:
    """flax ``EcgVit`` params -> the port's ``EcgVit`` state_dict."""
    cfg.require_vit_block('the JAX conversion (models/port.py)')
    with torch.device('meta'):
        model = EcgVit(cfg)
    return state_dict_from_flax(params, model)


def mim_state_dict_from_flax(params: Mapping, cfg: VitConfig) -> Dict[str, torch.Tensor]:
    """flax ``EcgMim`` params (``train/long_record.py``) -> the port's
    ``EcgMim`` state_dict."""
    from ..train.long_record import EcgMim
    with torch.device('meta'):
        model = EcgMim(cfg)
    return state_dict_from_flax(params, model)


def merge_pipeline_tree(outer: Mapping, stages: Mapping) -> Dict:
    """A JAX pipeline pair -- ``outer`` ({'params': everything but the block
    stack}) and ``stages`` (the stack's leaves, (S, L / S, ...)) of
    ``train/pipeline_vit.split_vit_params`` -- as numpy arrays -> the flax
    tree of the scan-stacked ViT (JAX's ``merge_vit_params``)."""
    tree = dict(outer['params'] if 'params' in outer else outer)
    tree['encoder'] = {**tree['encoder'], 'blocks': _map_leaves(
        stages, lambda a: np.asarray(a).reshape(-1, *np.shape(a)[2:]))}
    return {'params': tree}


def pipeline_state_dict_from_flax(outer: Mapping, stages: Mapping, cfg: VitConfig
                                  ) -> Dict[str, torch.Tensor]:
    """A JAX pipeline pair (``merge_pipeline_tree``) -> the port's
    ``EcgVit(scan_blocks=True)`` state_dict (``PipelineVitTrainer``'s
    ``set_merged_params`` takes it)."""
    return vit_state_dict_from_flax(merge_pipeline_tree(outer, stages),
                                    dataclasses.replace(cfg, scan_blocks=True))


def _state_dict_of_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A params-shaped tree of a JAX checkpoint (params, EMA, a moment) ->
    the port's state_dict; a pipeline's {'outer', 'stages'} pair becomes
    the one-device scan-stacked layout."""
    if 'outer' in tree and 'stages' in tree:
        tree = merge_pipeline_tree(tree['outer'], tree['stages'])
    return flax_tree_to_state_dict(tree)


def _adam_state(opt_state) -> Mapping:
    """The {count, mu, nu} node of a raw restore of either of the JAX
    package's optimizer states (its ``train/optim.adam_moments``): a
    ``FusedAdamWState`` (a dict), or the optax chain
    ``(clip, (scale_by_adam, wd, lr))`` (lists), whose Adam state is
    ``[1][0]``."""
    node = opt_state
    if isinstance(opt_state, (list, tuple)) and len(opt_state) == 2 \
            and isinstance(opt_state[1], (list, tuple)) and opt_state[1]:
        node = opt_state[1][0]
    if not (isinstance(node, Mapping) and {'count', 'mu', 'nu'} <= set(node)):
        raise ValueError('unknown optimizer-state layout: expected a FusedAdamWState or '
                         'the optax chain (clip, (scale_by_adam, wd, lr))')
    return node


def train_state_from_flax(tree: Mapping, epoch: int = 0) -> Dict[str, Any]:
    """A JAX train-state checkpoint, restored without a template (nested
    dicts of numpy arrays: ``step``, ``params``, ``opt_state``, ``rng``,
    ``ema_params`` when saved) -> the port's checkpoint state
    (``train/checkpoint.py``): the parameters, the EMA, Adam's ``count``,
    ``mu`` and ``nu`` (from a ``FusedAdamWState`` or an optax chain), the step
    and ``epoch``.  A pipeline checkpoint becomes the one-device
    ``scan_blocks`` file.  The JAX PRNG key is not carried: the port draws
    its randomness from torch generators, so a converted checkpoint has no
    ``rng`` and a trainer restoring it keeps its own, seeded from its
    config."""
    adam = _adam_state(tree['opt_state'])
    state: Dict[str, Any] = {
        'step': int(np.asarray(tree['step'])), 'epoch': int(epoch),
        'params': _state_dict_of_tree(tree['params']),
        'opt_state': {'count': int(np.asarray(adam['count'])),
                      'mu': _state_dict_of_tree(adam['mu']),
                      'nu': _state_dict_of_tree(adam['nu'])}}
    if tree.get('ema_params') is not None:
        state['ema_params'] = _state_dict_of_tree(tree['ema_params'])
    return state


def _map_leaves(tree: Mapping, fn) -> Dict:
    return {k: _map_leaves(v, fn) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def flax_path(key: str) -> Tuple[str, ...]:
    """The flax path of the port's parameter ``key``: ``blocks.i`` ->
    ``block_i``; a ``weight`` is a LayerNorm's ``scale`` when its module is a
    norm (every LayerNorm of the port is named ``*norm*``), else a Dense
    ``kernel`` -- whatever its dims: a stacked ``scan_blocks`` LayerNorm
    scale is 2-D, a stacked kernel 3-D."""
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
        path[-1] = 'scale' if 'norm' in path[-2] else 'kernel'
    return tuple(path)


def flax_params_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`state_dict_from_flax`: a state_dict of the port's
    ``EcgVit``, ``EcgMae`` or ``EcgContrastive`` -> ``{'params': ...}`` with
    numpy leaves (Dense kernels transposed back to (in, out))."""
    tree: Dict = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy()
        path = flax_path(key)
        if path[-1] == 'kernel':
            arr = np.swapaxes(arr, -1, -2)
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


# ---------------------------------------------------------------------------
# reference vit-pytorch 0.33.2 checkpoints
# ---------------------------------------------------------------------------
def reference_vit_config(model_key: str = 'ecg-vit-base', **overrides) -> VitConfig:
    """A ``VitConfig`` whose forward matches the reference wrapper of
    vit-pytorch 0.33.2 (no patch norms, exact-erf GELU, cls pool)."""
    kw = {'patch_norm': False, 'dtype': 'float32', **overrides}
    return VitConfig.from_defined(model_key, **kw)


def _np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> float32 numpy."""
    if hasattr(t, 'detach'):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def strip_wrapper_prefix(state_dict: Mapping[str, object]) -> Dict[str, object]:
    """Drop the reference wrapper's ``vit.`` prefix (EcgVit.vit,
    ecg_vit.py:116), leaving bare vit-pytorch keys."""
    return {(k[len('vit.'):] if k.startswith('vit.') else k): v
            for k, v in state_dict.items()}


def vit_pytorch_to_flax(state_dict: Mapping[str, object], cfg: VitConfig) -> Dict:
    """vit-pytorch 0.33.2 ``state_dict`` -> the flax ``{'params': ...}``
    tree of ``EcgVit`` (numpy leaves).  Raises ``ValueError`` unless
    ``cfg.patch_norm`` is False, ``KeyError`` on a missing key and
    ``ValueError`` on a shape mismatch, so a partial port cannot pass."""
    if cfg.patch_norm:
        raise ValueError('reference checkpoints need patch_norm=False '
                         '(vit-pytorch 0.33.2 has no patch-embedding norms); '
                         'build the config via reference_vit_config()')
    sd = strip_wrapper_prefix(state_dict)
    d = cfg.hidden_size
    c, p = cfg.num_channels, cfg.patch_size
    patch_dim = c * p

    def take(key: str, shape) -> np.ndarray:
        arr = _np(sd[key])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f'{key}: expected shape {tuple(shape)}, '
                             f'got {tuple(arr.shape)}')
        return arr

    # patch projection: torch rows are (dim, patch_dim) with columns ordered
    # (time, channel); flax's is a (patch_dim, dim) kernel with rows ordered
    # (channel, time)
    w = take('to_patch_embedding.1.weight', (d, patch_dim))
    w = w.reshape(d, p, c).transpose(2, 1, 0).reshape(patch_dim, d)
    encoder: Dict = {
        'patch_embed': {'proj': {'kernel': w,
                                 'bias': take('to_patch_embedding.1.bias', (d,))}},
        'cls_token': take('cls_token', (1, 1, d)),
        'pos_embed': take('pos_embedding', (1, cfg.num_patches + 1, d)),
        'final_norm': {'scale': take('mlp_head.0.weight', (d,)),
                       'bias': take('mlp_head.0.bias', (d,))},
    }
    for i in range(cfg.num_hidden_layers):
        pre = f'transformer.layers.{i}'
        encoder[f'block_{i}'] = {
            'norm1': {'scale': take(f'{pre}.0.norm.weight', (d,)),
                      'bias': take(f'{pre}.0.norm.bias', (d,))},
            'attn': {
                'qkv': {'kernel': take(f'{pre}.0.fn.to_qkv.weight', (3 * d, d)).T},
                'out': {'kernel': take(f'{pre}.0.fn.to_out.0.weight', (d, d)).T,
                        'bias': take(f'{pre}.0.fn.to_out.0.bias', (d,))},
            },
            'norm2': {'scale': take(f'{pre}.1.norm.weight', (d,)),
                      'bias': take(f'{pre}.1.norm.bias', (d,))},
            'mlp': {
                'fc1': {'kernel': take(f'{pre}.1.fn.net.0.weight',
                                       (cfg.intermediate_size, d)).T,
                        'bias': take(f'{pre}.1.fn.net.0.bias', (cfg.intermediate_size,))},
                'fc2': {'kernel': take(f'{pre}.1.fn.net.3.weight',
                                       (d, cfg.intermediate_size)).T,
                        'bias': take(f'{pre}.1.fn.net.3.bias', (d,))},
            },
        }
    return {'params': {
        'encoder': encoder,
        'head': {'kernel': take('mlp_head.1.weight', (cfg.num_class, d)).T,
                 'bias': take('mlp_head.1.bias', (cfg.num_class,))}}}


def port_vit_pytorch_state_dict(state_dict: Mapping[str, object],
                                cfg: VitConfig) -> Dict[str, torch.Tensor]:
    """vit-pytorch 0.33.2 ``state_dict`` -> the port's ``EcgVit``
    ``state_dict`` (``vit_pytorch_to_flax``, then ``vit_state_dict_from_flax``;
    the errors are theirs)."""
    return vit_state_dict_from_flax(vit_pytorch_to_flax(state_dict, cfg), cfg)


def export_vit_pytorch_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: VitConfig,
                                  wrapper_prefix: bool = True) -> Dict[str, np.ndarray]:
    """Inverse of :func:`port_vit_pytorch_state_dict`: the port's ``EcgVit``
    ``state_dict`` -> a vit-pytorch-0.33.2 ``state_dict`` with numpy values
    (``torch.from_numpy`` each to load it into the reference ``EcgVit``).
    ``wrapper_prefix=True`` emits the reference wrapper's ``vit.`` prefix."""
    if cfg.patch_norm:
        raise ValueError('only patch_norm=False models map onto the '
                         'vit-pytorch 0.33.2 layout')
    p = flax_params_from_state_dict(state_dict)['params']
    enc = p['encoder']
    d, c, ps = cfg.hidden_size, cfg.num_channels, cfg.patch_size
    out: Dict[str, np.ndarray] = {}

    def put(key: str, arr):
        out[('vit.' if wrapper_prefix else '') + key] = np.asarray(arr, np.float32)

    w = np.asarray(enc['patch_embed']['proj']['kernel'], np.float32)
    # (C*P, dim) rows ordered (channel, time) -> (dim, P*C) cols ordered (time, channel)
    put('to_patch_embedding.1.weight',
        w.reshape(c, ps, d).transpose(2, 1, 0).reshape(d, ps * c))
    put('to_patch_embedding.1.bias', enc['patch_embed']['proj']['bias'])
    put('cls_token', enc['cls_token'])
    put('pos_embedding', enc['pos_embed'])
    for i in range(cfg.num_hidden_layers):
        b = enc[f'block_{i}']
        pre = f'transformer.layers.{i}'
        put(f'{pre}.0.norm.weight', b['norm1']['scale'])
        put(f'{pre}.0.norm.bias', b['norm1']['bias'])
        put(f'{pre}.0.fn.to_qkv.weight', b['attn']['qkv']['kernel'].T)
        put(f'{pre}.0.fn.to_out.0.weight', b['attn']['out']['kernel'].T)
        put(f'{pre}.0.fn.to_out.0.bias', b['attn']['out']['bias'])
        put(f'{pre}.1.norm.weight', b['norm2']['scale'])
        put(f'{pre}.1.norm.bias', b['norm2']['bias'])
        put(f'{pre}.1.fn.net.0.weight', b['mlp']['fc1']['kernel'].T)
        put(f'{pre}.1.fn.net.0.bias', b['mlp']['fc1']['bias'])
        put(f'{pre}.1.fn.net.3.weight', b['mlp']['fc2']['kernel'].T)
        put(f'{pre}.1.fn.net.3.bias', b['mlp']['fc2']['bias'])
    put('mlp_head.0.weight', enc['final_norm']['scale'])
    put('mlp_head.0.bias', enc['final_norm']['bias'])
    put('mlp_head.1.weight', p['head']['kernel'].T)
    put('mlp_head.1.bias', p['head']['bias'])
    return out


def read_reference_state_dict(path: str) -> Mapping[str, torch.Tensor]:
    """A reference ``.pt`` file's ``state_dict``: the file holds a plain
    ``state_dict`` or ``{'state_dict': ...}`` (PL-style)."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd, dict) and 'state_dict' in sd:
        sd = sd['state_dict']
    return sd


def load_reference_checkpoint(path: str, model_key: str = 'ecg-vit-base', **overrides):
    """One call from a reference ``.pt`` file to a runnable model:
    ``(model, state_dict, cfg)``, the model on the CPU with the weights
    loaded (reference ``load_trained``, ecg_vit.py:152-161, with the path
    given)."""
    cfg = reference_vit_config(model_key, **overrides)
    state_dict = port_vit_pytorch_state_dict(read_reference_state_dict(path), cfg)
    model = EcgVit(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.eval(), state_dict, cfg
