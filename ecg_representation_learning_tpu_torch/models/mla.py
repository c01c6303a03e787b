"""DeepSeek-V3's block on the ECG trunk: RMSNorm, multi-head latent
attention (MLA) with decoupled RoPE, and the SwiGLU MLP
(``VitConfig.block == 'deepseek'``; the MoE layer is ``models/moe.py``'s
``DeepseekMoe``).

The layer equations are those of DeepSeek-V2/V3 (arXiv 2405.04434,
2412.19437) as ``modeling_deepseek.py`` computes them, without query
compression (``q_lora_rank`` null) and with no biases:

  * q = W_q x, per head a ``qk_nope_head_dim`` part and a ``qk_rope_head_dim``
    rotary part;
  * [c, k_pe] = W_kva x; kv = W_kvb RMSNorm(c) (eps 1e-6, the norm's default
    there) gives each head's k_nope and v; the one rotary key k_pe is shared
    by all heads;
  * RoPE (theta ``rope_theta``, no scaling) on q_pe and k_pe at positions
    0..T-1 (the cls token at 0), in the interleaved-pair layout that
    ``modeling_deepseek.py`` permutes to halves before ``rotate_half``;
  * softmax((q_nope k_nope + q_pe k_pe) / sqrt(nope + rope)) v, then W_o.

Departures from the decoder, for an ECG encoder: attention is bidirectional
(no causal mask), as the ViT's is, and the positions are those of the
record's patches.  Attention always takes the plain path of
``ops.attention.attention`` (the flash kernels take one head width for q, k
and v); 128 tokens or more are refused.

Linear layers are the trunk's ``Dense`` (bf16 with ``dtype='bfloat16'``);
RMSNorm computes in f32 and returns f32, as the trunk's LayerNorm does.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import VitConfig
from ..ops.attention import attention

LATENT_NORM_EPS = 1e-6      # modeling_deepseek.py's RMSNorm default (kv_a_layernorm)
MAX_TOKENS = 128            # the plain attention path's limit here


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight over the last axis, in f32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.rms_norm(x.float(), self.weight.shape, self.weight, self.eps)


def rope_tables(t: int, dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (t, dim) f32: the frequencies of ``dim / 2`` pairs,
    repeated over the two halves (``modeling_deepseek.py``'s cat(freqs, freqs))."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim))
    freqs = torch.outer(torch.arange(t, device=device, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE of ``x`` (..., T, D) in f32, its last axis read as interleaved
    pairs (x0, x1), (x2, x3), ... and returned in the halves layout
    [x0, x2, ..., x1, x3, ...] that the rotation writes (as in
    ``modeling_deepseek.py``; q and k take the same permutation, so their
    products are those of the interleaved rotation)."""
    *lead, d = x.shape
    x = x.float().reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


class LatentAttention(nn.Module):
    """MLA without query compression; ``forward(x, residual)`` returns
    ``residual`` + the attention output."""

    def __init__(self, cfg: VitConfig, dtype: torch.dtype):
        super().__init__()
        from .vit import Dense   # local: vit imports this module
        h = cfg.num_attention_heads
        self.cfg = cfg
        self.q_proj = Dense(cfg.hidden_size, h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
                            bias=False, dtype=dtype)
        self.kv_a_proj_with_mqa = Dense(cfg.hidden_size, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                                        bias=False, dtype=dtype)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, LATENT_NORM_EPS)
        self.kv_b_proj = Dense(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                               bias=False, dtype=dtype)
        self.o_proj = Dense(h * cfg.v_head_dim, cfg.hidden_size, bias=False, dtype=dtype)

    def forward(self, x, residual):
        cfg = self.cfg
        b, t, _ = x.shape
        if t >= MAX_TOKENS:
            raise ValueError(f'latent attention runs the plain attention path, for fewer than '
                             f'{MAX_TOKENS} tokens; got {t}')
        h, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim)
        q = self.q_proj(x).reshape(b, t, h, dn + dr).transpose(1, 2)          # (B, H, T, dn+dr)
        ckv = self.kv_a_proj_with_mqa(x)
        c, k_pe = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).reshape(b, t, h, dn + dv).transpose(1, 2)
        cos, sin = rope_tables(t, dr, cfg.rope_theta, x.device)
        q_pe = apply_rope(q[..., dn:], cos, sin).to(q.dtype)
        k_pe = apply_rope(k_pe[:, None], cos, sin).to(q.dtype).expand(b, h, t, dr)
        query = torch.cat([q[..., :dn], q_pe], dim=-1)
        key = torch.cat([kv[..., :dn], k_pe], dim=-1)
        out = attention(query, key, kv[..., dn:], use_flash=False)           # (B, H, T, dv)
        return residual + self.o_proj(out.transpose(1, 2).reshape(b, t, h * dv))


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)), no biases."""

    def __init__(self, dim: int, inner: int, dtype: torch.dtype):
        super().__init__()
        from .vit import Dense
        self.gate_proj = Dense(dim, inner, bias=False, dtype=dtype)
        self.up_proj = Dense(dim, inner, bias=False, dtype=dtype)
        self.down_proj = Dense(inner, dim, bias=False, dtype=dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DeepseekBlock(nn.Module):
    """Pre-RMSNorm block: MLA, then a SwiGLU MLP or (``use_moe``) the
    ``DeepseekMoe`` layer.  ``forward`` returns (x, None, the MoE's
    sequence balance loss or None), as ``vit.Block`` does (no attention maps)."""

    def __init__(self, cfg: VitConfig, use_moe: bool, dtype: torch.dtype):
        super().__init__()
        from .moe import DeepseekMoe
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LatentAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = (DeepseekMoe(cfg, dtype) if use_moe
                    else SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype))

    def forward(self, x):
        x = self.self_attn(self.input_layernorm(x), x)
        y = self.mlp(self.post_attention_layernorm(x))
        if isinstance(y, tuple):
            return x + y[0], None, y[1]
        return x + y, None, None
