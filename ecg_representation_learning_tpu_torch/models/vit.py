"""1-D Vision Transformer for 12-lead ECG, as torch ``nn.Module``s.

Counterpart of the JAX package's ``models/vit.py`` (flax), module for module
and parameter for parameter, so ``models/port.py`` maps one state onto the
other.  Numerics kept from the flax model:

  * patch vectors are channel-major: (B, C, P, patch) -> (B, P, C*patch);
  * LayerNorm uses eps 1e-5 and computes in f32;
  * with ``dtype='bfloat16'`` every Linear casts its input, weight and bias
    to bf16 (flax ``Dense(dtype=bf16)``); the head stays f32;
  * the MLP's GELU is the exact erf form;
  * attention goes through ``ops.attention.attention``: flash attention
    (with its gradient) for T >= ``flash_min_seq``, plain attention below;
  * train mode applies dropout at the JAX sites, each with its salt: attention
    probabilities (the hashed mask, seeded per layer per step), the attention
    output (salt 2), the MLP hidden (3) and output (4), the embedding (5, at
    ``attention_probs_dropout_prob`` as the reference's emb_dropout);
  * ``return_attention`` runs the plain probabilities path and returns the
    per-layer attention maps (L, B, H, T, T) for rollout.

``remat`` (activation recompute) is not ported and raises: recomputing a
block would redraw its dropout seeds from the generators.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import VitConfig
from ..ops.attention import attention
from ..ops.dropout import DropoutRng, make_dropout

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _dtype(cfg: VitConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f'dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}')
    return _DTYPES[cfg.dtype]


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (input, weight and bias cast)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5, computed and returned in f32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class PatchEmbed1D(nn.Module):
    """(B, C, L) -> (B, n_patch, hidden): channel-major patch vectors, then
    [LayerNorm] -> Linear -> [LayerNorm]."""

    def __init__(self, cfg: VitConfig):
        super().__init__()
        self.cfg = cfg
        patch_dim = cfg.num_channels * cfg.patch_size
        if cfg.patch_norm:
            self.pre_norm = LayerNorm(patch_dim)
        self.proj = Dense(patch_dim, cfg.hidden_size, dtype=_dtype(cfg))
        if cfg.patch_norm:
            self.post_norm = LayerNorm(cfg.hidden_size)

    def forward(self, x):
        cfg = self.cfg
        b, c, length = x.shape
        if c != cfg.num_channels or length % cfg.patch_size:
            raise ValueError(f'expected (B, {cfg.num_channels}, L) with L a '
                             f'multiple of {cfg.patch_size}, got {tuple(x.shape)}')
        n_patch = length // cfg.patch_size
        patches = x.reshape(b, c, n_patch, cfg.patch_size)
        patches = patches.permute(0, 2, 1, 3).reshape(b, n_patch, c * cfg.patch_size)
        if cfg.patch_norm:
            patches = self.pre_norm(patches)
        h = self.proj(patches)
        if cfg.patch_norm:
            h = self.post_norm(h)
        return h


class SelfAttention(nn.Module):
    def __init__(self, cfg: VitConfig):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size, bias=False, dtype=dt)
        self.out = Dense(cfg.hidden_size, cfg.hidden_size, dtype=dt)
        self.drop = make_dropout(cfg.dropout_impl, cfg.hidden_dropout_prob, salt=2)

    def forward(self, x, rng: Optional[DropoutRng] = None, return_probs: bool = False):
        cfg = self.cfg
        b, t, _ = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, cfg.num_attention_heads, cfg.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)   # (B,H,T,D)
        probs = None
        if return_probs:
            scale = 1.0 / math.sqrt(cfg.head_dim)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            probs = torch.softmax(logits, dim=-1)
            out = torch.matmul(probs.to(v.dtype), v)
        else:
            rate = cfg.attention_probs_dropout_prob
            active = self.training and rate > 0.0
            out = attention(q, k, v, dropout_rate=rate, deterministic=not self.training,
                            seed=rng.seed() if active else 0,
                            use_flash=cfg.use_flash_attention, min_seq=cfg.flash_min_seq,
                            generator=rng.device if active else None)
        out = out.permute(0, 2, 1, 3).reshape(b, t, cfg.hidden_size)
        return self.drop(self.out(out), rng), probs


class Mlp(nn.Module):
    def __init__(self, cfg: VitConfig):
        super().__init__()
        dt = _dtype(cfg)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dt)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dt)
        self.drop1 = make_dropout(cfg.dropout_impl, cfg.hidden_dropout_prob, salt=3)
        self.drop2 = make_dropout(cfg.dropout_impl, cfg.hidden_dropout_prob, salt=4)

    def forward(self, x, rng: Optional[DropoutRng] = None):
        h = self.drop1(F.gelu(self.fc1(x), approximate='none'), rng)
        return self.drop2(self.fc2(h), rng)


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, cfg: VitConfig):
        super().__init__()
        self.norm1 = LayerNorm(cfg.hidden_size)
        self.attn = SelfAttention(cfg)
        self.norm2 = LayerNorm(cfg.hidden_size)
        self.mlp = Mlp(cfg)

    def forward(self, x, rng: Optional[DropoutRng] = None, return_probs: bool = False):
        attn_out, probs = self.attn(self.norm1(x), rng, return_probs)
        x = x + attn_out
        return x + self.mlp(self.norm2(x), rng), probs


class EcgVitEncoder(nn.Module):
    """Patch embed + cls token + pos emb + transformer stack + final norm."""

    def __init__(self, cfg: VitConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed1D(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.hidden_size))
        self.emb_drop = make_dropout(cfg.dropout_impl, cfg.attention_probs_dropout_prob,
                                     salt=5)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_norm = LayerNorm(cfg.hidden_size)

    def forward(self, x, rng: Optional[DropoutRng] = None,
                return_attention: bool = False):
        h = self.patch_embed(x)
        b, n_patch, hidden = h.shape
        cls = self.cls_token.expand(b, 1, hidden).to(h.dtype)
        h = torch.cat([cls, h], dim=1)
        h = h + self.pos_embed[:, :n_patch + 1].to(h.dtype)
        h = self.emb_drop(h, rng)
        maps = []
        for block in self.blocks:
            h, probs = block(h, rng, return_attention)
            maps.append(probs)
        h = self.final_norm(h)
        if return_attention:
            return h, torch.stack(maps, dim=0)   # (L, B, H, T, T)
        return h


@dataclasses.dataclass
class VitOutput:
    """Mirrors the reference ``ModelOutput(loss, logits)``."""
    logits: torch.Tensor
    loss: Optional[torch.Tensor] = None
    attention: Optional[torch.Tensor] = None


class EcgVit(nn.Module):
    """Supervised multi-label classifier (reference EcgVit, ecg_vit.py:95-149)."""

    def __init__(self, cfg: VitConfig):
        super().__init__()
        unported = {'moe_num_experts': cfg.moe_num_experts > 0,
                    'scan_blocks': cfg.scan_blocks,
                    'ring_axis': cfg.ring_axis is not None,
                    'remat': cfg.remat}
        if any(unported.values()):
            raise NotImplementedError(
                f'not ported: {[k for k, v in unported.items() if v]}')
        if cfg.pool not in ('cls', 'mean'):
            raise ValueError(f"pool must be 'cls' or 'mean', got {cfg.pool!r}")
        self.cfg = cfg
        self.encoder = EcgVitEncoder(cfg)
        self.head = nn.Linear(cfg.hidden_size, cfg.num_class)

    def forward(self, sample_values, labels=None, loss_reduction: str = 'mean',
                loss_weight=None, return_attention: bool = False,
                rng: Optional[DropoutRng] = None) -> VitOutput:
        """Logits (and the BCE loss when ``labels`` are given).  In train
        mode every active dropout site draws from ``rng``."""
        cfg = self.cfg
        if (self.training and rng is None
                and max(cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob) > 0):
            raise ValueError('a training forward with dropout needs rng=DropoutRng(...)')
        attn = None
        if return_attention:
            h, attn = self.encoder(sample_values, rng, return_attention=True)
        else:
            h = self.encoder(sample_values, rng)
        pooled = h[:, 0] if cfg.pool == 'cls' else h.mean(dim=1)
        logits = self.head(pooled.float())
        loss = None
        if labels is not None:
            loss = bce_with_logits(logits, labels, reduction=loss_reduction,
                                   weight=loss_weight)
        return VitOutput(logits=logits, loss=loss, attention=attn)


def bce_with_logits(logits, labels, reduction: str = 'mean', weight=None):
    """BCEWithLogitsLoss (reference ecg_vit.py:118, 140-149).

    ``weight``: optional length-2 (w_neg, w_pos) applied per element by label
    value.  ``reduction``: 'mean' | 'none' -- 'none' averages per sample over
    classes.
    """
    logits = logits.float()
    labels = labels.float()
    # numerically stable: max(x,0) - x*y + log1p(exp(-|x|))
    per_elem = (torch.clamp(logits, min=0.0) - logits * labels
                + torch.log1p(torch.exp(-torch.abs(logits))))
    if weight is not None:
        w = torch.as_tensor(weight, dtype=torch.float32, device=logits.device)
        per_elem = per_elem * w[labels.long()]
    if reduction == 'mean':
        return per_elem.mean()
    if reduction == 'none':
        return per_elem.mean(dim=-1)
    raise ValueError(f'Unknown reduction {reduction!r}')


def forward_flops_per_sample(cfg: VitConfig) -> float:
    """Analytic matmul FLOPs of one supervised forward pass per sample
    (2*M*K*N per GEMM; elementwise/LayerNorm omitted)."""
    t = cfg.num_patches + 1  # +cls token
    h, i = cfg.hidden_size, cfg.intermediate_size
    patch_embed = 2 * (cfg.num_channels * cfg.patch_size) * h * cfg.num_patches
    per_layer = (
        2 * h * 3 * h * t        # qkv projection
        + 2 * t * t * h          # q @ k^T (over all heads: H * T*T*D = T*T*h)
        + 2 * t * t * h          # probs @ v
        + 2 * h * h * t          # output projection
        + 2 * h * i * t * 2      # MLP fc1 + fc2
    )
    head = 2 * h * cfg.num_class
    return float(patch_embed + cfg.num_hidden_layers * per_layer + head)
