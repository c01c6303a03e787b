"""Plain PyTorch reference of the long-record masked-signal trunk (the port's
``train/long_record.py`` ``EcgMim`` on one card), as the cell
``vitb_long_mae_t2048`` trains it: the loss and its gradients, functional
over a dict of parameters named as the program's (``mim_shapes``).  Imports
nothing of the program under test and no kernel.

Written from SimMIM's masked-signal modelling (Xie et al., arXiv 2111.09886)
on the 1-D ViT of the reference repository's ``ecg_vit.py``: the patch
embedding (LayerNorm, Linear, LayerNorm); each masked patch's embedding
replaced by one learned mask token; a learned position table; the pre-norm
blocks of ``model.py`` (bidirectional softmax attention, exact GELU), no
dropout (the trunk trains deterministically); a final LayerNorm; an f32
Linear predicting each patch's 12 x 64 samples; the MSE against the
per-patch normalized target ((x - mean) / sqrt(var + 1e-6), the variance
without correction), averaged over a patch's samples, summed over the masked
patches and divided by their count over the batch.  The forward runs one
record at a time (records are independent; the loss's count is the
batch's), which changes no value.  ``mode`` as in ``model.py``: 'f32' or
'fp8' (the control).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import model as ref


def mim_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The parameters, in the order of the forward."""
    h, n = cfg['hidden_size'], ref.n_patches(cfg)
    pd = cfg['num_channels'] * cfg['patch_size']
    out = dict(ref.embed_shapes('patch_embed.', cfg))
    out.update({'mask_token': (1, 1, h), 'pos_embed': (1, n, h)})
    for i in range(cfg['num_hidden_layers']):
        out.update(ref.block_shapes(f'blocks.{i}.', h, cfg['intermediate_size']))
    out.update({'final_norm.weight': (h,), 'final_norm.bias': (h,), 'pred.weight': (pd, h),
                'pred.bias': (pd,)})
    return out


def loss_terms(p, x, mask, cfg: dict, mode: str = 'f32'):
    """(masked-MSE sum, masked count) of records ``x`` (B, C, L) under
    ``mask`` (B, P, 1 = masked)."""
    n = x.shape[-1] // cfg['patch_size']
    h = ref.patch_embed(p, 'patch_embed.', x, cfg, mode)
    h = torch.where(mask[..., None] > 0, p['mask_token'], h) + p['pos_embed'][:, :n]
    for i in range(cfg['num_hidden_layers']):
        h = ref.block(p, f'blocks.{i}.', h, cfg['num_attention_heads'], None, 0.0, 0.0, mode)
    h = ref.layer_norm(h, p['final_norm.weight'], p['final_norm.bias'])
    pred = F.linear(h, p['pred.weight'], p['pred.bias'])
    target = ref.patch_vectors(x, cfg['patch_size'])
    mu = target.mean(dim=-1, keepdim=True)
    var = target.var(dim=-1, keepdim=True, correction=0)
    target = (target - mu) / torch.sqrt(var + 1e-6)
    per_patch = ((pred - target) ** 2).mean(dim=-1)
    return (per_patch * mask).sum(), mask.sum()


def batch_grads(p, x, mask, cfg: dict, mode: str, half: bool = False):
    """(loss, gradients by leaf) of one step's batch, a record at a time;
    ``half`` (a planted fault) takes the loss over the first half of the
    batch alone."""
    n = x.shape[0] // 2 if half else x.shape[0]
    count = mask[:n].sum().clamp(min=1.0)
    names = list(p)
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total = 0.0
    for r in range(n):
        s, _ = loss_terms(p, x[r:r + 1], mask[r:r + 1], cfg, mode)
        for k, g in zip(names, torch.autograd.grad(s / count, [p[k] for k in names])):
            grads[k] += g
        total += float(s.detach()) / float(count)
    return total, grads
