"""Plain PyTorch reference of DeepSeek-V3's block on the ECG trunk, as the
configuration ``moonlight-16b-a3b-ep8-ptbxl`` runs it: the forward, the BCE,
both balance terms and the aux-loss-free bias update, functional over a dict
of parameters named as the program's (``moonlight_shapes``).  Imports nothing
of the program under test and no kernel.

Written from DeepSeek-V2/V3 (arXiv 2405.04434, 2412.19437) and
``modeling_deepseek.py`` beside Moonlight-16B-A3B's ``config.json``:

  * RMSNorm x / sqrt(mean(x^2) + eps) * w (eps ``rms_norm_eps``; 1e-6 on the
    latent, that norm's default);
  * MLA without query compression: q = W_q x split per head into a
    ``qk_nope_head_dim`` and a ``qk_rope_head_dim`` part; [c, k_pe] = W_kva x;
    [k_nope, v] per head = W_kvb RMSNorm(c); RoPE (theta ``rope_theta``) on
    q_pe and the one shared k_pe, their interleaved pairs permuted to halves
    and rotated with ``rotate_half``; softmax(q k^T / sqrt(nope + rope)) v;
    W_o;
  * SwiGLU down(silu(gate x) * up x); layer 0 dense, the others MoE;
  * the router: s = sigmoid(x W_r) in f32 over all experts, the top-k of s + b
    chosen (b the correction bias), gates s / sum(s over the chosen) (+1e-20)
    times ``routed_scaling_factor``; the output is the held experts' gated
    SwiGLU outputs plus the shared experts' SwiGLU (one of ``n_shared_experts``
    times the width); the experts absent from this device add nothing;
  * the sequence-wise balance loss per MoE layer: the mean over records of
    sum_i f_i P_i, f_i = E / (k T) times the record's choices of expert i,
    P_i the record's mean of s_i / sum_j s_j; summed over the layers;
  * after each optimizer step b_i += rate * sign(mean load - load_i), the
    loads counted over the step's records.

Departures from the published decoder, as the configuration lists them:
bidirectional attention (no causal mask), positions 0..T-1 of the cls token
and the patches, the ECG patch embedding and a 71-class head in place of the
vocabulary and the LM head, no dropout.

Routing is per token, so the forward of a batch equals the forward of its
records in any chunks (``batch_grads`` runs it in chunks to fit the card in
f32); only the balance counts sum over the chunks.  ``mode`` as in
``model.py``: 'f32' (TF32 off, the reference) or 'fp8' (the control).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import model as ref

LATENT_NORM_EPS = 1e-6


def moonlight_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The parameters (not the correction biases), in the order of the forward."""
    h, heads = cfg['hidden_size'], cfg['num_attention_heads']
    dn, dr, dv, r = (cfg['qk_nope_head_dim'], cfg['qk_rope_head_dim'], cfg['v_head_dim'],
                     cfg['kv_lora_rank'])
    f, held = cfg['moe_intermediate_size'], cfg['n_routed_experts']
    out = {'encoder.cls_token': (1, 1, h)}
    out.update(ref.embed_shapes('encoder.patch_embed.', cfg))
    for i in range(cfg['num_hidden_layers']):
        pre = f'encoder.blocks.{i}.'
        out.update({pre + 'input_layernorm.weight': (h,),
                    pre + 'self_attn.q_proj.weight': (heads * (dn + dr), h),
                    pre + 'self_attn.kv_a_proj_with_mqa.weight': (r + dr, h),
                    pre + 'self_attn.kv_a_layernorm.weight': (r,),
                    pre + 'self_attn.kv_b_proj.weight': (heads * (dn + dv), r),
                    pre + 'self_attn.o_proj.weight': (h, heads * dv),
                    pre + 'post_attention_layernorm.weight': (h,)})
        if i < cfg['first_k_dense_replace']:
            out.update(_swiglu_shapes(pre + 'mlp.', h, cfg['intermediate_size']))
        else:
            out.update({pre + 'mlp.gate.weight': (cfg['n_routed_experts_published'], h),
                        pre + 'mlp.experts.gate_up': (held, 2 * f, h),
                        pre + 'mlp.experts.down': (held, h, f)})
            out.update(_swiglu_shapes(pre + 'mlp.shared_experts.', h,
                                      f * cfg['n_shared_experts']))
    out.update({'encoder.final_norm.weight': (h,), 'head.weight': (cfg['num_class'], h),
                'head.bias': (cfg['num_class'],)})
    return out


def bias_names(cfg: dict) -> List[str]:
    """The correction biases (buffers of the program), one per MoE layer."""
    return [f'encoder.blocks.{i}.mlp.gate.e_score_correction_bias'
            for i in range(cfg['first_k_dense_replace'], cfg['num_hidden_layers'])]


def _swiglu_shapes(pre: str, h: int, inner: int) -> Dict[str, Tuple[int, ...]]:
    return {pre + 'gate_proj.weight': (inner, h), pre + 'up_proj.weight': (inner, h),
            pre + 'down_proj.weight': (h, inner)}


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def swiglu(x, wg, wu, wd, mode: str):
    return ref.linear(F.silu(ref.linear(x, wg, None, mode)) * ref.linear(x, wu, None, mode),
                      wd, None, mode)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x, theta: float):
    """``modeling_deepseek.py``'s apply_rotary_pos_emb on (B, H, T, D) at
    positions 0..T-1: interleaved pairs to halves, then rotate_half."""
    b, h, t, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    freqs = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    x = x.view(b, h, t, d // 2, 2).transpose(4, 3).reshape(b, h, t, d)
    return x * emb.cos() + rotate_half(x) * emb.sin()


def mla(p, pre: str, x, cfg: dict, mode: str):
    b, t, _ = x.shape
    heads = cfg['num_attention_heads']
    dn, dr, dv, r = (cfg['qk_nope_head_dim'], cfg['qk_rope_head_dim'], cfg['v_head_dim'],
                     cfg['kv_lora_rank'])
    q = ref.linear(x, p[pre + 'q_proj.weight'], None, mode).view(b, t, heads, dn + dr)
    q = q.transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = ref.linear(x, p[pre + 'kv_a_proj_with_mqa.weight'], None, mode)
    c, k_pe = ckv[..., :r], ckv[..., r:].view(b, t, 1, dr).transpose(1, 2)
    kv = ref.linear(rms_norm(c, p[pre + 'kv_a_layernorm.weight'], LATENT_NORM_EPS),
                    p[pre + 'kv_b_proj.weight'], None, mode)
    kv = kv.view(b, t, heads, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe, k_pe = rope(q_pe, cfg['rope_theta']), rope(k_pe, cfg['rope_theta'])
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(b, heads, t, dr)], dim=-1)
    probs = torch.softmax(query @ key.transpose(-1, -2) / math.sqrt(dn + dr), dim=-1)
    o = (probs @ v).transpose(1, 2).reshape(b, t, heads * dv)
    return ref.linear(o, p[pre + 'o_proj.weight'], None, mode)


def moe(p, pre: str, x, bias, cfg: dict, mode: str):
    """(output, balance loss, counts of each expert's choices, chosen experts
    (S, k)) of the MoE layer on ``x`` (B, T, d)."""
    b, t, d = x.shape
    e, k = cfg['n_routed_experts_published'], cfg['num_experts_per_tok']
    xs = x.reshape(b * t, d)
    scores = torch.sigmoid(xs @ p[pre + 'gate.weight'].t())
    idx = torch.topk(scores.detach() + bias, k, dim=-1).indices
    w = scores.gather(1, idx)
    gates = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg['routed_scaling_factor']
    out = torch.zeros_like(xs)
    first = cfg['held_first']
    gu, dn = p[pre + 'experts.gate_up'], p[pre + 'experts.down']
    f = cfg['moe_intermediate_size']
    for j in range(cfg['n_routed_experts']):
        tok, slot = torch.nonzero(idx == first + j, as_tuple=True)
        if tok.numel():
            y = swiglu(xs[tok], gu[j, :f], gu[j, f:], dn[j], mode)
            out = out.index_add(0, tok, y * gates[tok, slot][:, None])
    sh = pre + 'shared_experts.'
    out = out + swiglu(xs, p[sh + 'gate_proj.weight'], p[sh + 'up_proj.weight'],
                       p[sh + 'down_proj.weight'], mode)
    counts = torch.zeros(e, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device))
    per_seq = torch.zeros(b, e, device=x.device).scatter_add_(
        1, idx.reshape(b, t * k), torch.ones(b, t * k, device=x.device)) * (e / (k * t))
    share = (scores / scores.sum(dim=-1, keepdim=True)).view(b, t, e).mean(dim=1)
    aux = (per_seq * share).sum(dim=1).mean()
    return out.view(b, t, d), aux, counts, idx


def forward(p, biases: Dict[str, torch.Tensor], x, cfg: dict, mode: str = 'f32'):
    """(logits (B, classes), the summed balance loss, [counts per MoE layer],
    [chosen experts per MoE layer]) of normalized, patch-aligned (B, C, L)
    inputs.  The head is f32 in both modes."""
    h = ref.patch_embed(p, 'encoder.patch_embed.', x, cfg, mode)
    b, _, c = h.shape
    h = torch.cat([p['encoder.cls_token'].expand(b, 1, c), h], dim=1)
    aux = torch.zeros((), device=x.device)
    loads, chosen = [], []
    eps = cfg['rms_norm_eps']
    for i in range(cfg['num_hidden_layers']):
        pre = f'encoder.blocks.{i}.'
        h = h + mla(p, pre + 'self_attn.', rms_norm(h, p[pre + 'input_layernorm.weight'], eps),
                    cfg, mode)
        y = rms_norm(h, p[pre + 'post_attention_layernorm.weight'], eps)
        if i < cfg['first_k_dense_replace']:
            m = pre + 'mlp.'
            h = h + swiglu(y, p[m + 'gate_proj.weight'], p[m + 'up_proj.weight'],
                           p[m + 'down_proj.weight'], mode)
        else:
            y, a, counts, idx = moe(p, pre + 'mlp.', y,
                                    biases[pre + 'mlp.gate.e_score_correction_bias'], cfg, mode)
            h = h + y
            aux = aux + a
            loads.append(counts)
            chosen.append(idx)
    h = rms_norm(h, p['encoder.final_norm.weight'], eps)
    return F.linear(h[:, 0], p['head.weight'], p['head.bias']), aux, loads, chosen


def batch_grads(p, biases, x, y, cfg: dict, mode: str, chunk: int, half: bool = False):
    """(task loss, objective gradients by leaf, summed loads per MoE layer,
    chosen experts per MoE layer) of one step's batch, its records in chunks
    of ``chunk``.  The objective is the mean BCE plus ``seq_aux_weight`` times
    the mean over records of the summed balance loss; ``half`` (a planted
    fault) takes both over the first half of the batch alone."""
    n = x.shape[0] // 2 if half else x.shape[0]
    names = list(p)
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    loss_sum, loads, chosen = 0.0, None, None
    for lo in range(0, x.shape[0], chunk):
        hi = min(x.shape[0], lo + chunk)
        logits, aux, cl, idx = forward(p, biases, x[lo:hi], cfg, mode)
        take = max(0, min(hi, n) - lo)
        loads = cl if loads is None else [a + b for a, b in zip(loads, cl)]
        chosen = idx if chosen is None else [torch.cat([a, b]) for a, b in zip(chosen, idx)]
        if take == 0:
            continue
        if take != hi - lo:
            raise ValueError(f'the chunk {chunk} must divide the records of the loss, {n}')
        bce = ref.bce(logits, y[lo:hi])
        obj = (bce + cfg['seq_aux_weight'] * aux) * (take / n)
        # a chunk that routes no token to a held expert leaves it unused
        for k, g in zip(names, torch.autograd.grad(obj, [p[k] for k in names],
                                                   allow_unused=True)):
            if g is not None:
                grads[k] += g
        loss_sum += float(bce.detach()) * take / n
    return loss_sum, grads, loads, chosen


def update_biases(biases: Dict[str, torch.Tensor], loads: List[torch.Tensor], rate: float):
    """The aux-loss-free step of every MoE layer's bias, in place."""
    for name, load in zip(biases, loads):
        biases[name].add_(torch.sign(load.mean() - load), alpha=rate)
