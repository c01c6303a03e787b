"""The benchmark's frozen yardsticks: matmul FLOPs of the models, bytes of
the fused AdamW step, and the card's published peaks.

The FLOP counts are 2 * M * K * N per matrix product (elementwise work,
LayerNorm and softmax left out), a training step 3x the forward (the
standard 1:2 forward:backward ratio).  Peaks: NVIDIA's data sheet for one
H100 SXM (dense bf16, HBM3 bandwidth), which assumes the 700 W power limit;
each reading is printed beside the card's limit.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

# one AdamW step per f32 leaf element: the update reads param, grad, mu, nu
# and writes param, mu, nu (28 bytes); the global norm reads the grad (4)
ADAMW_BYTES_PER_PARAM = 32


def block_flops(tokens: int, hidden: int, inner: int) -> float:
    """One transformer block's forward per sample."""
    t, h = tokens, hidden
    return float(2 * h * 3 * h * t        # qkv
                 + 2 * t * t * h          # q @ k^T over all heads
                 + 2 * t * t * h          # probs @ v
                 + 2 * h * h * t          # output projection
                 + 2 * 2 * h * inner * t)  # MLP fc1 + fc2


def vit_forward_flops(cfg: dict) -> float:
    """The supervised ViT's forward per sample: patch embedding, the blocks
    over the patches plus the cls token, the head."""
    p = cfg['max_signal_length'] // cfg['patch_size']
    h = cfg['hidden_size']
    embed = 2 * cfg['num_channels'] * cfg['patch_size'] * h * p
    return float(embed + cfg['num_hidden_layers']
                 * block_flops(p + 1, h, cfg['intermediate_size'])
                 + 2 * h * cfg['num_class'])


def mae_forward_flops(cfg: dict) -> float:
    """The MAE's forward per sample: patch embedding of every patch, the
    encoder over the visible patches, the decoder over all of them, the
    prediction of every patch."""
    p = cfg['max_signal_length'] // cfg['patch_size']
    v = max(1, int(round(p * (1.0 - cfg['mask_ratio']))))
    h, d = cfg['hidden_size'], cfg['decoder_hidden_size']
    pd = cfg['num_channels'] * cfg['patch_size']
    return float(2 * pd * h * p
                 + cfg['num_hidden_layers'] * block_flops(v, h, cfg['intermediate_size'])
                 + 2 * h * d * v
                 + cfg['decoder_num_layers'] * block_flops(p, d, cfg['decoder_intermediate_size'])
                 + 2 * d * pd * p)


def train_flops_per_sample(cfg: dict) -> float:
    fwd = mae_forward_flops(cfg) if cfg['model'] == 'mae' else vit_forward_flops(cfg)
    return 3.0 * fwd


def param_count(shapes: Dict[str, Tuple[int, ...]]) -> int:
    return sum(math.prod(s) for s in shapes.values())


def adamw_bound_s(n_params: int) -> float:
    """The least time one AdamW step (norm and update) can take on the card."""
    return ADAMW_BYTES_PER_PARAM * n_params / H100_HBM_BYTES_PER_S
