"""Plain PyTorch reference of the benchmark's models, loss and optimizer.

Written from the published descriptions (the 1-D ViT of the reference
repository's ``ecg_vit.py``, He et al.'s masked autoencoder, BCE, global-norm
clipping and AdamW with a warm-up cosine schedule), functional over a dict of
parameters named as the configuration's parameter list (``vit_shapes``,
``mae_shapes``).  Imports nothing of the program under test.

``mode`` is the precision of the Linear layers: 'f32' (float32 with TF32 off,
the reference) or 'fp8' (the control: inputs and weights rounded to float8
e4m3 with one scale per tensor, the step below the configurations' bf16).

Dropout and the MAE mask are drawn by :class:`Draws` from the run's seed, in
the order a training forward visits its sites: the embedding (supervised
model only), then per block the attention probabilities (raw 32-bit draws
against round((1 - rate) * (2^32 - 1))), the attention output, the MLP hidden
and the MLP output (Bernoulli keep masks, kept values divided by the keep
probability).  The MAE draws its mask noise before the encoder.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

U32 = 0xFFFFFFFF


class Draws:
    """The random draws of a training run from its seed: a CPU generator
    seeded with the seed gives the seed of one generator on ``device``,
    which every mask is drawn from."""

    def __init__(self, seed: int, device):
        host = torch.Generator().manual_seed(int(seed))
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(torch.randint(0, 1 << 62, (1,), generator=host)))

    def keep(self, shape, p: float) -> torch.Tensor:
        return torch.empty(shape, device=self.device).bernoulli_(p, generator=self.gen)

    def bits(self, shape) -> torch.Tensor:
        return torch.randint(0, 1 << 32, shape, dtype=torch.int64, generator=self.gen,
                             device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with one scale per tensor (amax to 448); the
    gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def linear(x, w, b, mode: str):
    if mode == 'fp8':
        x, w = _Fp8.apply(x), _Fp8.apply(w)
    elif mode != 'f32':
        raise ValueError(f'mode must be f32 or fp8, got {mode!r}')
    return F.linear(x, w, b)


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def dropout(x, draws: Optional[Draws], rate: float):
    if draws is None or rate == 0.0:
        return x
    keep = draws.keep(x.shape, 1.0 - rate)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


def block(p: Dict[str, torch.Tensor], pre: str, x, heads: int, draws: Optional[Draws],
          attn_rate: float, hidden_rate: float, mode: str):
    """A pre-norm transformer block."""
    b, t, c = x.shape
    d = c // heads
    y = layer_norm(x, p[pre + 'norm1.weight'], p[pre + 'norm1.bias'])
    qkv = linear(y, p[pre + 'attn.qkv.weight'], None, mode).reshape(b, t, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
    if draws is not None and attn_rate > 0.0:
        keep = draws.bits(probs.shape) < round((1.0 - attn_rate) * float(U32))
        probs = probs * keep.to(probs.dtype) / (1.0 - attn_rate)
    o = (probs @ v).permute(0, 2, 1, 3).reshape(b, t, c)
    o = linear(o, p[pre + 'attn.out.weight'], p[pre + 'attn.out.bias'], mode)
    x = x + dropout(o, draws, hidden_rate)
    y = layer_norm(x, p[pre + 'norm2.weight'], p[pre + 'norm2.bias'])
    y = F.gelu(linear(y, p[pre + 'mlp.fc1.weight'], p[pre + 'mlp.fc1.bias'], mode))
    y = dropout(y, draws, hidden_rate)
    y = linear(y, p[pre + 'mlp.fc2.weight'], p[pre + 'mlp.fc2.bias'], mode)
    return x + dropout(y, draws, hidden_rate)


def patch_vectors(x, patch: int):
    """(B, C, L) -> (B, L / patch, C * patch), channel-major."""
    b, c, length = x.shape
    n = length // patch
    return x.reshape(b, c, n, patch).permute(0, 2, 1, 3).reshape(b, n, c * patch)


def patch_embed(p, pre: str, x, cfg: dict, mode: str):
    h = patch_vectors(x, cfg['patch_size'])
    h = layer_norm(h, p[pre + 'pre_norm.weight'], p[pre + 'pre_norm.bias'])
    h = linear(h, p[pre + 'proj.weight'], p[pre + 'proj.bias'], mode)
    return layer_norm(h, p[pre + 'post_norm.weight'], p[pre + 'post_norm.bias'])


def block_shapes(pre: str, c: int, inner: int) -> Dict[str, Tuple[int, ...]]:
    return {pre + 'norm1.weight': (c,), pre + 'norm1.bias': (c,),
            pre + 'attn.qkv.weight': (3 * c, c),
            pre + 'attn.out.weight': (c, c), pre + 'attn.out.bias': (c,),
            pre + 'norm2.weight': (c,), pre + 'norm2.bias': (c,),
            pre + 'mlp.fc1.weight': (inner, c), pre + 'mlp.fc1.bias': (inner,),
            pre + 'mlp.fc2.weight': (c, inner), pre + 'mlp.fc2.bias': (c,)}


def embed_shapes(pre: str, cfg: dict) -> Dict[str, Tuple[int, ...]]:
    pd, h = cfg['num_channels'] * cfg['patch_size'], cfg['hidden_size']
    return {pre + 'pre_norm.weight': (pd,), pre + 'pre_norm.bias': (pd,),
            pre + 'proj.weight': (h, pd), pre + 'proj.bias': (h,),
            pre + 'post_norm.weight': (h,), pre + 'post_norm.bias': (h,)}


def n_patches(cfg: dict) -> int:
    return cfg['max_signal_length'] // cfg['patch_size']


# ----------------------------------------------------------------- classifier
def vit_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The supervised ViT's parameters, in the order of its forward."""
    h = cfg['hidden_size']
    out = {'encoder.cls_token': (1, 1, h), 'encoder.pos_embed': (1, n_patches(cfg) + 1, h)}
    out.update(embed_shapes('encoder.patch_embed.', cfg))
    for i in range(cfg['num_hidden_layers']):
        out.update(block_shapes(f'encoder.blocks.{i}.', h, cfg['intermediate_size']))
    out.update({'encoder.final_norm.weight': (h,), 'encoder.final_norm.bias': (h,),
                'head.weight': (cfg['num_class'], h), 'head.bias': (cfg['num_class'],)})
    return out


def vit_logits(p, x, cfg: dict, draws: Optional[Draws] = None, mode: str = 'f32'):
    """Logits (B, classes) of normalized, patch-aligned (B, C, L) inputs;
    ``draws`` None is the eval forward (no dropout).  The head is f32 in both
    modes, as the configuration states."""
    h = patch_embed(p, 'encoder.patch_embed.', x, cfg, mode)
    b, n, c = h.shape
    h = torch.cat([p['encoder.cls_token'].expand(b, 1, c), h], dim=1)
    h = h + p['encoder.pos_embed'][:, :n + 1]
    h = dropout(h, draws, cfg['attention_probs_dropout_prob'])
    for i in range(cfg['num_hidden_layers']):
        h = block(p, f'encoder.blocks.{i}.', h, cfg['num_attention_heads'], draws,
                  cfg['attention_probs_dropout_prob'], cfg['hidden_dropout_prob'], mode)
    h = layer_norm(h, p['encoder.final_norm.weight'], p['encoder.final_norm.bias'])
    return F.linear(h[:, 0], p['head.weight'], p['head.bias'])


def bce(logits, labels):
    """Mean binary cross-entropy with logits over every (sample, class)."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


# ------------------------------------------------------------------------ MAE
def mae_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    h, d, n = cfg['hidden_size'], cfg['decoder_hidden_size'], n_patches(cfg)
    out = {'encoder_pos_embed': (1, n, h)}
    out.update(embed_shapes('encoder_patch_embed.', cfg))
    for i in range(cfg['num_hidden_layers']):
        out.update(block_shapes(f'encoder_blocks.{i}.', h, cfg['intermediate_size']))
    out.update({'encoder_norm.weight': (h,), 'encoder_norm.bias': (h,),
                'decoder.mask_token': (1, 1, d), 'decoder.pos_embed': (1, n, d),
                'decoder.embed.weight': (d, h), 'decoder.embed.bias': (d,)})
    for i in range(cfg['decoder_num_layers']):
        out.update(block_shapes(f'decoder.blocks.{i}.', d, cfg['decoder_intermediate_size']))
    pd = cfg['num_channels'] * cfg['patch_size']
    out.update({'decoder.norm.weight': (d,), 'decoder.norm.bias': (d,),
                'decoder.pred.weight': (pd, d), 'decoder.pred.bias': (pd,)})
    return out


def _take(h, ids):
    return torch.gather(h, 1, ids[:, :, None].expand(-1, -1, h.shape[-1]))


def mae_loss(p, x, cfg: dict, draws: Draws, mode: str = 'f32', half: bool = False):
    """Masked reconstruction loss of normalized, patch-aligned (B, C, L)
    inputs: a per-sample random mask keeps round(P * (1 - ratio)) patches
    (stable argsort of uniform noise), the encoder sees those, the decoder
    restores the sequence with a shared mask token and predicts every patch;
    MSE on the masked patches against per-patch normalized targets.  The
    prediction layer is f32 in both modes, as the configuration states.
    ``half`` (a planted fault) takes the loss over the first half of the
    batch alone."""
    b = x.shape[0]
    n = x.shape[-1] // cfg['patch_size']
    keep_n = max(1, int(round(n * (1.0 - cfg['mask_ratio']))))
    noise = draws.uniform((b, n))
    shuffle = torch.argsort(noise, dim=1, stable=True)
    restore = torch.argsort(shuffle, dim=1, stable=True)
    mask = torch.ones((b, n), device=x.device)
    mask[:, :keep_n] = 0.0
    mask = torch.gather(mask, 1, restore)

    attn, hid = cfg['attention_probs_dropout_prob'], cfg['hidden_dropout_prob']
    h = patch_embed(p, 'encoder_patch_embed.', x, cfg, mode) + p['encoder_pos_embed'][:, :n]
    h = _take(h, shuffle[:, :keep_n])
    for i in range(cfg['num_hidden_layers']):
        h = block(p, f'encoder_blocks.{i}.', h, cfg['num_attention_heads'], draws, attn, hid,
                  mode)
    h = layer_norm(h, p['encoder_norm.weight'], p['encoder_norm.bias'])

    h = linear(h, p['decoder.embed.weight'], p['decoder.embed.bias'], mode)
    d = h.shape[-1]
    h = torch.cat([h, p['decoder.mask_token'].expand(b, n - keep_n, d)], dim=1)
    h = _take(h, restore) + p['decoder.pos_embed'][:, :n]
    for i in range(cfg['decoder_num_layers']):
        h = block(p, f'decoder.blocks.{i}.', h, cfg['decoder_num_heads'], draws, attn, hid,
                  mode)
    h = layer_norm(h, p['decoder.norm.weight'], p['decoder.norm.bias'])
    pred = F.linear(h, p['decoder.pred.weight'], p['decoder.pred.bias'])

    target = patch_vectors(x, cfg['patch_size'])
    if cfg['norm_patch_targets']:
        mu = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=0)
        target = (target - mu) / torch.sqrt(var + 1e-6)
    per_patch = ((pred - target) ** 2).mean(dim=-1)
    if half:
        per_patch, mask = per_patch[:b // 2], mask[:b // 2]
    return (per_patch * mask).sum() / mask.sum().clamp(min=1.0)


# ------------------------------------------------------------------ optimizer
def learning_rate(count: int, total_steps: int, train: dict) -> float:
    """The warm-up cosine schedule at optimizer step ``count`` (0-based):
    linear from 0 over round(total * warmup_ratio) steps, then cosine to 0
    over the rest."""
    lr = train['learning_rate']
    warm = int(round(total_steps * train['warmup_ratio']))
    if count < warm:
        return lr * count / warm
    decay = max(total_steps, 2) - warm
    c = min(count - warm, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))


class AdamW:
    """Global-norm clipping, then AdamW (bias-corrected moments, decoupled
    weight decay on every parameter) on a dict of f32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], train: dict, total_steps: int):
        self.train, self.total = train, total_steps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> torch.Tensor:
        """Update ``params`` in place; returns the gradient norm before the
        clip."""
        t = self.train
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = torch.clamp(t['grad_clip_norm'] / torch.clamp(norm, min=1e-16), max=1.0)
        lr = learning_rate(self.count, self.total, t)
        self.count += 1
        b1, b2 = t['b1'], t['b2']
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for k, p in params.items():
            g = grads[k] * scale
            self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + t['eps'])
            p.sub_(lr * (u + t['weight_decay'] * p))
        return norm
