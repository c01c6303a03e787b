"""Frozen yardsticks of the DeepSeek-V3 block's training step: matmul FLOPs
and parameters of a configuration like ``moonlight-16b-a3b-ep8-ptbxl``.

FLOPs are 2 * M * K * N per matrix product (elementwise work, norms,
softmax, routing and the permutation left out), a training step 3x the
forward, as ``yardstick.py`` counts them.  The held experts' share is
counted from the rows the program actually routed to them (its held-row
counter), since dropless routing makes it depend on the data; the buffer
rows past the last group offset are not computed and not counted.
"""
from __future__ import annotations

from . import yardstick

H100_BF16_FLOPS = yardstick.H100_BF16_FLOPS


def moe_layers(cfg: dict) -> int:
    return cfg['num_hidden_layers'] - cfg['first_k_dense_replace']


def _attention_per_token(cfg: dict, tokens: int) -> float:
    h, heads = cfg['hidden_size'], cfg['num_attention_heads']
    dn, dr, dv, r = (cfg['qk_nope_head_dim'], cfg['qk_rope_head_dim'], cfg['v_head_dim'],
                     cfg['kv_lora_rank'])
    return float(2 * h * heads * (dn + dr) + 2 * h * (r + dr) + 2 * r * heads * (dn + dv)
                 + 2 * heads * dv * h + 2 * tokens * heads * (dn + dr)
                 + 2 * tokens * heads * dv)


def expert_row_flops(cfg: dict) -> float:
    """One routed row through one SwiGLU expert, forward (gate, up, down)."""
    return 6.0 * cfg['hidden_size'] * cfg['moe_intermediate_size']


def forward_flops_unrouted(cfg: dict) -> float:
    """The forward per sample without the routed experts: patch embedding,
    latent attention, the dense MLP, router and shared experts, the head."""
    p = cfg['max_signal_length'] // cfg['patch_size']
    t = p + 1
    h = cfg['hidden_size']
    embed = 2 * cfg['num_channels'] * cfg['patch_size'] * h * p
    attn = _attention_per_token(cfg, t) * t * cfg['num_hidden_layers']
    dense = 6 * h * cfg['intermediate_size'] * t * cfg['first_k_dense_replace']
    per_moe = (2 * h * cfg['n_routed_experts_published']
               + 6 * h * cfg['moe_intermediate_size'] * cfg['n_shared_experts'])
    return float(embed + attn + dense + per_moe * t * moe_layers(cfg) + 2 * h * cfg['num_class'])


def train_flops(cfg: dict, samples: int, held_rows: int) -> float:
    """A training window's matmul FLOPs: ``samples`` records, ``held_rows``
    rows routed to the held experts over every MoE layer and step."""
    return 3.0 * (samples * forward_flops_unrouted(cfg) + held_rows * expert_row_flops(cfg))


def grouped_gemm_flops(cfg: dict, held_rows: int) -> float:
    """The held experts' grouped GEMMs, forward and backward, for
    ``held_rows`` routed rows."""
    return 3.0 * held_rows * expert_row_flops(cfg)


def param_count(cfg: dict) -> int:
    from .reference.moonlight import moonlight_shapes
    return yardstick.param_count(moonlight_shapes(cfg))
