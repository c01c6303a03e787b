"""Arcee's AFMoE block (Trinity) on the ECG trunk: grouped-query attention
with QK-norm and a sigmoid output gate, causal, sliding-window and full
layers, sandwich RMSNorms, and the SwiGLU MLP or DeepSeek-V3's MoE layer
(``VitConfig.block == 'afmoe'``, an ``AfmoeConfig``).

The layer equations, from AFMoE's published description (Trinity's model
card and ``config.json``, ``model_type`` afmoe), with no biases:

  * a = RMSNorm_in(h); q = W_q a (H heads of ``head_dim``), k = W_k a and
    v = W_v a (H_kv heads each);
  * per-head RMSNorm of q and of k over ``head_dim`` (eps ``rms_norm_eps``);
  * RoPE (theta ``rope_theta``, the halves layout of ``rotate_half``, every
    dimension) on q and k of the sliding layers at positions 0..T-1; the full
    layers take no positions;
  * o = softmax(q k^T / sqrt(head_dim)) v over the keys the layer sees: causal
    (``causal``), and on a sliding layer the query and the
    ``sliding_window`` - 1 keys before it; query head h reads KV head
    h // (H / H_kv); then o times sigmoid(W_g a) (W_g: hidden -> H head_dim)
    and W_o;
  * h = h + RMSNorm_post_attn(W_o(...)); h = h + RMSNorm_post_mlp(MLP(
    RMSNorm_pre_mlp(h))), the MLP a SwiGLU for the first
    ``first_k_dense_replace`` layers and ``DeepseekMoe`` after them (sigmoid
    router, top-k of s + b, gates normalized and scaled, shared experts).

The attention core runs ``ops.attention.attention`` with the band and the KV
heads as they are (flash kernels #1-#4 from ``flash_min_seq`` tokens on, no
expanded copy of k and v); region marks 'attn.window' and 'attn.full'
(``utils.tracing``) time it by layer kind, from q, k, v to its output.
Linear layers are the trunk's ``Dense``; norms, RoPE and the gate compute in
f32, as the trunk's LayerNorm does.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..configs import VitConfig
from ..ops.attention import attention
from .mla import RMSNorm, SwiGLU, rope_tables


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class GatedAttention(nn.Module):
    """AFMoE's attention of layer ``layer``; ``forward(a)`` returns W_o of
    the gated attention output of the normed input ``a``."""

    def __init__(self, cfg: VitConfig, layer: int, dtype: torch.dtype):
        super().__init__()
        from .vit import Dense   # local: vit imports this module
        h, hk, d, hid = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                         cfg.hidden_size)
        if h % hk:
            raise ValueError(f'{h} query heads do not group over {hk} KV heads')
        self.cfg, self.sliding = cfg, cfg.sliding(layer)
        self.q_proj = Dense(hid, h * d, bias=False, dtype=dtype)
        self.k_proj = Dense(hid, hk * d, bias=False, dtype=dtype)
        self.v_proj = Dense(hid, hk * d, bias=False, dtype=dtype)
        self.q_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.k_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.gate_proj = Dense(hid, h * d, bias=False, dtype=dtype)
        self.o_proj = Dense(h * d, hid, bias=False, dtype=dtype)

    def forward(self, a):
        from ..utils import tracing
        cfg = self.cfg
        b, t, _ = a.shape
        h, hk, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = self.q_norm(self.q_proj(a).reshape(b, t, h, d)).transpose(1, 2)     # f32
        k = self.k_norm(self.k_proj(a).reshape(b, t, hk, d)).transpose(1, 2)
        v = self.v_proj(a).reshape(b, t, hk, d).transpose(1, 2)
        if self.sliding:
            cos, sin = rope_tables(t, d, cfg.rope_theta, a.device)
            q = q * cos + rotate_half(q) * sin
            k = k * cos + rotate_half(k) * sin
        q, k, v = (x.to(v.dtype).contiguous() for x in (q, k, v))
        tracing.region(None)
        o = attention(q, k, v, use_flash=cfg.use_flash_attention, min_seq=cfg.flash_min_seq,
                      causal=cfg.causal,
                      window_left=cfg.sliding_window - 1 if self.sliding else -1)
        tracing.region('attn.window' if self.sliding else 'attn.full')
        o = o.transpose(1, 2).reshape(b, t, h * d)
        return self.o_proj(o * torch.sigmoid(self.gate_proj(a).float()))


class AfmoeBlock(nn.Module):
    """The sandwich-norm block: gated attention, then a SwiGLU MLP or (layers
    from ``first_k_dense_replace`` on) ``DeepseekMoe``.  ``forward`` returns
    (x, None, the MoE's sequence balance loss or None), as ``vit.Block``."""

    def __init__(self, cfg: VitConfig, layer: int, use_moe: bool, dtype: torch.dtype):
        super().__init__()
        from .moe import DeepseekMoe
        eps = cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.self_attn = GatedAttention(cfg, layer, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.pre_mlp_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.mlp = (DeepseekMoe(cfg, dtype) if use_moe
                    else SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype))
        self.post_mlp_layernorm = RMSNorm(cfg.hidden_size, eps)

    def forward(self, x):
        x = x + self.post_attention_layernorm(self.self_attn(self.input_layernorm(x)))
        y = self.mlp(self.pre_mlp_layernorm(x))
        aux = None
        if isinstance(y, tuple):
            y, aux = y
        return x + self.post_mlp_layernorm(y), None, aux


def embed_scale(cfg: VitConfig) -> float:
    """The muP embedding multiplier: sqrt(hidden) when ``mup``, else 1."""
    return math.sqrt(cfg.hidden_size) if cfg.mup else 1.0
