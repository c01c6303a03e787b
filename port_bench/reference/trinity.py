"""Plain PyTorch reference of Arcee's AFMoE block (Trinity) on the ECG trunk,
as the configuration ``trinity-mini-ep16-ecg8k`` runs it: the forward, the
BCE, the aux-loss-free bias update, functional over a dict of parameters
named as the program's (``trinity_shapes``).  Imports nothing of the program
under test and no kernel; run it with TF32 off (``checks.follow`` and the
driver set it).

Written from AFMoE's published description (Trinity-Mini's ``config.json``,
``model_type`` afmoe, and Arcee's model card) and DeepSeek-V3 (arXiv
2412.19437, section 2.1.2) for the router:

  * RMSNorm x / sqrt(mean(x^2) + eps) * w, eps ``rms_norm_eps``;
  * the embedding: the ECG patch embedding (LayerNorm, Linear, LayerNorm)
    times sqrt(hidden_size) (``mup_enabled``); no position table, no cls
    token;
  * attention: a = RMSNorm_in(h); q = W_q a, k = W_k a, v = W_v a
    (``num_attention_heads`` and ``num_key_value_heads`` heads of
    ``head_dim``); per-head RMSNorm of q and k; on ``sliding_attention``
    layers RoPE (theta ``rope_theta``, ``rotate_half`` over every dimension)
    at positions 0..T-1; softmax(q k^T / sqrt(head_dim)) v over the keys a
    query sees -- causal, and on a sliding layer the query and the
    ``sliding_window`` - 1 keys before it -- as a dense masked softmax with
    each KV head repeated for its group of query heads; times
    sigmoid(W_g a); W_o; h = h + RMSNorm_post_attn(that);
  * the MLP: h = h + RMSNorm_post_mlp(MLP(RMSNorm_pre_mlp(h))), a SwiGLU of
    ``intermediate_size`` for the first ``num_dense_layers`` layers, then
    the MoE: s = sigmoid(x W_r) over all ``num_experts_published`` experts,
    the top ``num_experts_per_tok`` of s + b (b the correction bias), gates s
    over the chosen ones' sum (+1e-20) times ``route_scale``; the held
    experts' gated SwiGLU outputs plus the shared expert's SwiGLU; the
    experts absent from this device add nothing;
  * a final RMSNorm, the mean over the tokens, the f32 head;
  * after each optimizer step b_i += rate * sign(mean load - load_i) over the
    step's choices.

Departures from the published decoder, as the configuration lists them:
the ECG patch embedding and a 71-class head on the mean of the tokens in
place of the vocabulary and the LM head; no sequence balance loss (the
configuration names none).  To fit the card in f32 at 8,192 tokens, the
forward runs one record at a time (routing is per token and the mean pool
per record, so records are independent), each block under
``torch.utils.checkpoint`` and the attention's queries in chunks
(``chunk``); none of these changes a value.  ``mode`` as in ``model.py``:
'f32' or 'fp8' (the control).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as ref
from .moonlight import rms_norm, rotate_half, swiglu, update_biases  # noqa: F401


def sliding(cfg: dict, i: int) -> bool:
    return cfg['layer_types'][i] == 'sliding_attention'


def trinity_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The parameters (not the correction biases), in the order of the forward."""
    h, heads, kvh, d = (cfg['hidden_size'], cfg['num_attention_heads'],
                        cfg['num_key_value_heads'], cfg['head_dim'])
    f, held = cfg['moe_intermediate_size'], cfg['num_experts']
    out = dict(ref.embed_shapes('encoder.patch_embed.', cfg))
    for i in range(cfg['num_hidden_layers']):
        pre = f'encoder.blocks.{i}.'
        a = pre + 'self_attn.'
        out.update({pre + 'input_layernorm.weight': (h,),
                    a + 'q_proj.weight': (heads * d, h), a + 'k_proj.weight': (kvh * d, h),
                    a + 'v_proj.weight': (kvh * d, h), a + 'q_norm.weight': (d,),
                    a + 'k_norm.weight': (d,), a + 'gate_proj.weight': (heads * d, h),
                    a + 'o_proj.weight': (h, heads * d),
                    pre + 'post_attention_layernorm.weight': (h,),
                    pre + 'pre_mlp_layernorm.weight': (h,)})
        m = pre + 'mlp.'
        if i < cfg['num_dense_layers']:
            out.update(_swiglu_shapes(m, h, cfg['intermediate_size']))
        else:
            out.update({m + 'gate.weight': (cfg['num_experts_published'], h),
                        m + 'experts.gate_up': (held, 2 * f, h),
                        m + 'experts.down': (held, h, f)})
            out.update(_swiglu_shapes(m + 'shared_experts.', h, f * cfg['num_shared_experts']))
        out[pre + 'post_mlp_layernorm.weight'] = (h,)
    out.update({'encoder.final_norm.weight': (h,), 'head.weight': (cfg['num_class'], h),
                'head.bias': (cfg['num_class'],)})
    return out


def bias_names(cfg: dict) -> List[str]:
    """The correction biases (buffers of the program), one per MoE layer."""
    return [f'encoder.blocks.{i}.mlp.gate.e_score_correction_bias'
            for i in range(cfg['num_dense_layers'], cfg['num_hidden_layers'])]


def _swiglu_shapes(pre: str, h: int, inner: int) -> Dict[str, Tuple[int, ...]]:
    return {pre + 'gate_proj.weight': (inner, h), pre + 'up_proj.weight': (inner, h),
            pre + 'down_proj.weight': (h, inner)}


def rope(x, theta: float):
    """RoPE of (B, H, T, D) at positions 0..T-1 in the halves layout."""
    t, d = x.shape[-2:]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    freqs = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return x * emb.cos() + rotate_half(x) * emb.sin()


def masked_attention(q, k, v, causal: bool, window: int, chunk: int):
    """softmax(q k^T / sqrt(D)) v over the visible keys, dense, with k and v
    (B, H_kv, T, D) repeated to q's heads; queries in chunks of ``chunk``.
    ``window``: the keys a query sees, its own included (0: all)."""
    b, h, t, d = q.shape
    g = h // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    j = torch.arange(t, device=q.device)[None, :]
    outs = []
    for lo in range(0, t, chunk):
        hi = min(t, lo + chunk)
        i = torch.arange(lo, hi, device=q.device)[:, None]
        vis = torch.ones((hi - lo, t), dtype=torch.bool, device=q.device)
        if causal:
            vis &= j <= i
        if window > 0:
            vis &= j > i - window
        s = (q[:, :, lo:hi] @ k.transpose(-1, -2)) / math.sqrt(d)
        outs.append(torch.softmax(s.masked_fill(~vis, float('-inf')), dim=-1) @ v)
    return torch.cat(outs, dim=2)


def attention(p, pre: str, x, cfg: dict, layer: int, mode: str, chunk: int):
    b, t, _ = x.shape
    heads, kvh, d, eps = (cfg['num_attention_heads'], cfg['num_key_value_heads'],
                          cfg['head_dim'], cfg['rms_norm_eps'])
    q = ref.linear(x, p[pre + 'q_proj.weight'], None, mode).view(b, t, heads, d)
    k = ref.linear(x, p[pre + 'k_proj.weight'], None, mode).view(b, t, kvh, d)
    v = ref.linear(x, p[pre + 'v_proj.weight'], None, mode).view(b, t, kvh, d).transpose(1, 2)
    q = rms_norm(q, p[pre + 'q_norm.weight'], eps).transpose(1, 2)
    k = rms_norm(k, p[pre + 'k_norm.weight'], eps).transpose(1, 2)
    window = 0
    if sliding(cfg, layer):
        q, k = rope(q, cfg['rope_theta']), rope(k, cfg['rope_theta'])
        window = cfg['sliding_window']
    o = masked_attention(q, k, v, cfg['causal'], window, chunk)
    o = o.transpose(1, 2).reshape(b, t, heads * d)
    o = o * torch.sigmoid(ref.linear(x, p[pre + 'gate_proj.weight'], None, mode))
    return ref.linear(o, p[pre + 'o_proj.weight'], None, mode)


def moe(p, pre: str, x, bias, cfg: dict, mode: str):
    """(output, counts of each expert's choices, chosen experts (S, k)) of the
    MoE layer on ``x`` (B, T, d)."""
    b, t, d = x.shape
    e, k = cfg['num_experts_published'], cfg['num_experts_per_tok']
    xs = x.reshape(b * t, d)
    scores = torch.sigmoid(xs @ p[pre + 'gate.weight'].t())
    idx = torch.topk(scores.detach() + bias, k, dim=-1).indices
    w = scores.gather(1, idx)
    gates = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg['route_scale']
    out = torch.zeros_like(xs)
    first, f = cfg['held_first'], cfg['moe_intermediate_size']
    gu, dn = p[pre + 'experts.gate_up'], p[pre + 'experts.down']
    for j in range(cfg['num_experts']):
        tok, slot = torch.nonzero(idx == first + j, as_tuple=True)
        if tok.numel():
            y = swiglu(xs[tok], gu[j, :f], gu[j, f:], dn[j], mode)
            out = out.index_add(0, tok, y * gates[tok, slot][:, None])
    sh = pre + 'shared_experts.'
    out = out + swiglu(xs, p[sh + 'gate_proj.weight'], p[sh + 'up_proj.weight'],
                       p[sh + 'down_proj.weight'], mode)
    counts = torch.zeros(e, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device))
    return out.view(b, t, d), counts, idx


def _block(p, biases, h, cfg: dict, i: int, mode: str, chunk: int):
    """Block ``i``: (h, the MoE's counts or None, its chosen experts or None)."""
    pre = f'encoder.blocks.{i}.'
    eps = cfg['rms_norm_eps']
    a = attention(p, pre + 'self_attn.', rms_norm(h, p[pre + 'input_layernorm.weight'], eps),
                  cfg, i, mode, chunk)
    h = h + rms_norm(a, p[pre + 'post_attention_layernorm.weight'], eps)
    y = rms_norm(h, p[pre + 'pre_mlp_layernorm.weight'], eps)
    counts = idx = None
    m = pre + 'mlp.'
    if i < cfg['num_dense_layers']:
        y = swiglu(y, p[m + 'gate_proj.weight'], p[m + 'up_proj.weight'],
                   p[m + 'down_proj.weight'], mode)
    else:
        y, counts, idx = moe(p, m, y, biases[m + 'gate.e_score_correction_bias'], cfg, mode)
    return h + rms_norm(y, p[pre + 'post_mlp_layernorm.weight'], eps), counts, idx


def forward(p, biases: Dict[str, torch.Tensor], x, cfg: dict, mode: str = 'f32',
            chunk: int = 1024, remat: bool = False):
    """(logits (B, classes), [counts per MoE layer], [chosen experts per MoE
    layer]) of normalized, patch-aligned (B, C, L) inputs; ``remat`` runs each
    block under ``torch.utils.checkpoint``."""
    h = ref.patch_embed(p, 'encoder.patch_embed.', x, cfg, mode) * math.sqrt(cfg['hidden_size'])
    loads, chosen = [], []
    for i in range(cfg['num_hidden_layers']):
        if remat:
            h, counts, idx = checkpoint(_block, p, biases, h, cfg, i, mode, chunk,
                                        use_reentrant=False)
        else:
            h, counts, idx = _block(p, biases, h, cfg, i, mode, chunk)
        if counts is not None:
            loads.append(counts)
            chosen.append(idx)
    h = rms_norm(h, p['encoder.final_norm.weight'], cfg['rms_norm_eps'])
    return F.linear(h.mean(dim=1), p['head.weight'], p['head.bias']), loads, chosen


def batch_grads(p, biases, x, y, cfg: dict, mode: str, chunk: int, half: bool = False,
                remat: bool = True):
    """(task loss, gradients by leaf, summed loads per MoE layer, chosen
    experts per MoE layer) of one step's batch, one record at a time.  The
    objective is the mean BCE; ``half`` (a planted fault) takes it over the
    first half of the batch alone."""
    n = x.shape[0] // 2 if half else x.shape[0]
    names = list(p)
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    loss_sum, loads, chosen = 0.0, None, None
    for r in range(x.shape[0]):
        logits, cl, idx = forward(p, biases, x[r:r + 1], cfg, mode, chunk, remat)
        loads = cl if loads is None else [a + b for a, b in zip(loads, cl)]
        chosen = idx if chosen is None else [torch.cat([a, b]) for a, b in zip(chosen, idx)]
        if r >= n:
            continue
        bce = ref.bce(logits, y[r:r + 1])
        # a record that routes no token to a held expert leaves it unused
        for k, g in zip(names, torch.autograd.grad(bce / n, [p[k] for k in names],
                                                   allow_unused=True)):
            if g is not None:
                grads[k] += g
        loss_sum += float(bce.detach()) / n
    return loss_sum, grads, loads, chosen
