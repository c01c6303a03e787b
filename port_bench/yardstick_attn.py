"""Frozen yardsticks of the long-record cells: the FLOPs that attention's
mathematics needs over a band of visible (query, key) pairs, the matmul FLOPs
and parameters of AFMoE's block (``trinity-mini-ep16-ecg8k``) and of the
masked-signal trunk on long records.

Attention's FLOPs count the pairs a query sees, whatever computes them: per
head and pair, 2 D for q.k and 2 D for p.v forward, twice that backward (dQ,
dK, dV: 4 D, plus the recomputed probabilities' dP = dO.v: 4 D in all 8 D;
the recompute of q.k is not counted).  The rest as ``yardstick.py``: 2 M K N
a product, a step 3x the forward, elementwise work, norms and routing left
out.  The held experts' rows come from the program's held-row counter, as
``yardstick_moe.py`` counts them.
"""
from __future__ import annotations

from . import yardstick

H100_BF16_FLOPS = yardstick.H100_BF16_FLOPS
FORWARD_PER_PAIR, BACKWARD_PER_PAIR = 4, 8      # times D
# the device kernels of flash #1-#4 (CUDA names hold these)
FLASH_KERNELS = ('flash_fwd_bf16', 'flash_fwd_f32', 'bwd_dq_bf16', 'bwd_dq_f32', 'bwd_dkv_bf16',
                 'bwd_dkv_f32')


def visible_pairs(t: int, causal: bool, window_left: int = -1) -> int:
    """The (query, key) pairs one head sees over T tokens: T^2
    bidirectional, T (T + 1) / 2 causal, and causal with a window of W' =
    ``window_left`` + 1 keys W' (W' + 1) / 2 + (T - W') W'."""
    if not causal:
        if window_left >= 0:
            raise ValueError('a bidirectional window is not counted here')
        return t * t
    w = window_left + 1 if 0 <= window_left < t else t
    return w * (w + 1) // 2 + (t - w) * w


def attention_train_flops(heads: int, t: int, d: int, causal: bool,
                          window_left: int = -1) -> float:
    """One layer's attention core, forward and backward, for one sample."""
    return float(heads * visible_pairs(t, causal, window_left) * d
                 * (FORWARD_PER_PAIR + BACKWARD_PER_PAIR))


# ----------------------------------------------------------------- AFMoE
def afmoe_tokens(cfg: dict) -> int:
    return cfg['max_signal_length'] // cfg['patch_size']


def afmoe_attention_flops(cfg: dict) -> float:
    """The attention cores of a training step's sample, over every layer."""
    t, heads, d = afmoe_tokens(cfg), cfg['num_attention_heads'], cfg['head_dim']
    total = 0.0
    for i in range(cfg['num_hidden_layers']):
        win = cfg['sliding_window'] - 1 if cfg['layer_types'][i] == 'sliding_attention' else -1
        total += attention_train_flops(heads, t, d, cfg['causal'], win)
    return total


def afmoe_moe_layers(cfg: dict) -> int:
    return cfg['num_hidden_layers'] - cfg['num_dense_layers']


def afmoe_expert_row_flops(cfg: dict) -> float:
    """One routed row through one SwiGLU expert, forward."""
    return 6.0 * cfg['hidden_size'] * cfg['moe_intermediate_size']


def afmoe_forward_flops_unrouted(cfg: dict) -> float:
    """The forward per sample without the routed experts: the patch
    embedding, the projections (q, k, v, gate, o), the attention cores, the
    dense MLPs, router and shared expert, the head."""
    t, h = afmoe_tokens(cfg), cfg['hidden_size']
    heads, kvh, d = cfg['num_attention_heads'], cfg['num_key_value_heads'], cfg['head_dim']
    embed = 2 * cfg['num_channels'] * cfg['patch_size'] * h * t
    proj = 2 * h * (3 * heads * d + 2 * kvh * d) * t
    cores = afmoe_attention_flops(cfg) * FORWARD_PER_PAIR / (FORWARD_PER_PAIR
                                                            + BACKWARD_PER_PAIR)
    dense = 6 * h * cfg['intermediate_size'] * t * cfg['num_dense_layers']
    per_moe = (2 * h * cfg['num_experts_published']
               + 6 * h * cfg['moe_intermediate_size'] * cfg['num_shared_experts'])
    return float(embed + proj * cfg['num_hidden_layers'] + cores + dense
                 + per_moe * t * afmoe_moe_layers(cfg) + 2 * h * cfg['num_class'])


def afmoe_train_flops(cfg: dict, samples: int, held_rows: int) -> float:
    """A training window's matmul FLOPs: ``samples`` records, ``held_rows``
    rows routed to the held experts over every MoE layer and step."""
    return 3.0 * (samples * afmoe_forward_flops_unrouted(cfg)
                  + held_rows * afmoe_expert_row_flops(cfg))


def afmoe_param_count(cfg: dict) -> int:
    from .reference.trinity import trinity_shapes
    return yardstick.param_count(trinity_shapes(cfg))


# ------------------------------------------------- masked-signal trunk
def mim_tokens(cfg: dict) -> int:
    return cfg['max_signal_length'] // cfg['patch_size']


def mim_attention_flops(cfg: dict) -> float:
    """The bidirectional attention cores of a training step's sample."""
    heads = cfg['num_attention_heads']
    return cfg['num_hidden_layers'] * attention_train_flops(
        heads, mim_tokens(cfg), cfg['hidden_size'] // heads, False)


def mim_forward_flops(cfg: dict) -> float:
    """``EcgMim``'s forward per sample: the patch embedding, the blocks over
    every patch, the prediction of every patch."""
    p, h = mim_tokens(cfg), cfg['hidden_size']
    pd = cfg['num_channels'] * cfg['patch_size']
    return float(2 * pd * h * p
                 + cfg['num_hidden_layers'] * yardstick.block_flops(p, h, cfg['intermediate_size'])
                 + 2 * h * pd * p)

