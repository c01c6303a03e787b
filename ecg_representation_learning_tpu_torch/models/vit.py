"""1-D Vision Transformer for 12-lead ECG, as torch ``nn.Module``s.

Counterpart of the JAX package's ``models/vit.py`` (flax), module for module
and parameter for parameter, so ``models/port.py`` maps one state onto the
other.  Numerics kept from the flax model:

  * patch vectors are channel-major: (B, C, P, patch) -> (B, P, C*patch);
  * LayerNorm uses eps 1e-5 and computes in f32;
  * with ``dtype='bfloat16'`` every Linear casts its input, weight and bias
    to bf16 (flax ``Dense(dtype=bf16)``); the head stays f32; every Linear,
    the head included, can compute with an int8 weight (``models/quantize``);
  * the MLP's GELU is the exact erf form;
  * attention goes through ``ops.attention.attention``: flash attention
    (with its gradient) for T >= ``flash_min_seq``, plain attention below;
  * train mode applies dropout at the JAX sites, each with its salt: attention
    probabilities (the hashed mask, seeded per layer per step), the attention
    output (salt 2), the MLP hidden (3) and output (4), the embedding (5, at
    ``attention_probs_dropout_prob`` as the reference's emb_dropout);
  * ``return_attention`` runs the plain probabilities path and returns the
    per-layer attention maps (L, B, H, T, T) for rollout.

The model options of the JAX encoder:

  * ``moe_num_experts > 0``: block i is a Switch-MoE block when
    (i + 1) % ``moe_every`` == 0 (``models/moe.py``); the model output
    carries the mean aux loss of those blocks (``VitOutput.aux_loss``, 0 for
    a dense model);
  * ``remat``: each block runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward; the recompute puts the generators of the
    block's ``DropoutRng`` back in their state before the block, so it draws
    the same seeds and masks, and then restores them, so a step with remat
    gives the bits of a step without (``return_attention`` turns it off, as
    in JAX);
  * ``scan_blocks``: the blocks' parameters stacked (L, ...) under one
    ``blocks`` module, in the leaf order of JAX's ``encoder/blocks``, with
    the one block function applied layer by layer
    (``stack_unrolled_state_dict`` and ``unstack_scanned_state_dict``
    convert between the layouts).  MoE blocks differ per layer, so MoE with
    ``scan_blocks`` is refused, as in JAX.

On a mesh (``parallel/mesh.py``) the modules run the Megatron plan that
``ShardedModel`` gives them: a ``Dense`` with ``tp`` 'col' / 'row' /
'gather' is column-parallel, row-parallel (its bias added after the sum over
'model'), or column-parallel with its output gathered; ``SelfAttention``
runs its ``heads`` (H / n_model); every dropout site passes where its
tensor sits in the global one (``parallel.spmd.frame``), and the attention
kernel the first global bh of the rank's rows.

With ``ring_axis`` set (context parallelism, ``train/long_record.py``) the
sequence is split over that axis of the current mesh and ``SelfAttention``
runs ``parallel.ring_attention.ring_attention_local``: no
attention-probability dropout on that path, and its output dropout takes
salt 1, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs import VitConfig
from ..ops.attention import attention
from ..ops.dropout import DropoutRng, make_dropout
from ..parallel import spmd
from .moe import MoeMlp, mean_aux, moe_layer

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _dtype(cfg: VitConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f'dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}')
    return _DTYPES[cfg.dtype]


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (input, weight and bias cast).
    While ``int8`` holds an (int8 weight, scales) pair (set by
    ``models.quantize.int8_weights``), the layer computes with that weight
    dequantized in place of its own.  ``tp`` (set by
    ``parallel.mesh.ShardedModel``): None, or the Megatron role of the rank's
    slice of the weight -- 'col' (output features), 'row' (input features:
    the partial products summed over 'model', then the bias) or 'gather'
    (output features, gathered after the product, then the bias)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.int8 = None
        self.tp = None

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        w = self.weight if self.int8 is None else self.int8[0].float() * self.int8[1]
        if self.tp is None or spmd.model_index()[1] == 1:   # one model rank: one product
            return F.linear(x.to(dt), w.to(dt), bias)
        if self.tp == 'col':
            return F.linear(spmd.copy_to_model(x).to(dt), w.to(dt), bias)
        if self.tp == 'row':
            y = spmd.reduce_from_model(F.linear(x.to(dt), w.to(dt)))
        else:
            y = spmd.gather_from_model(F.linear(spmd.copy_to_model(x).to(dt), w.to(dt)))
        return y if bias is None else y + bias


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
        self.heads = cfg.num_attention_heads   # the rank's heads under the Megatron plan
        dt = _dtype(cfg)
        self.qkv = Dense(cfg.hidden_size, 3 * cfg.hidden_size, bias=False, dtype=dt)
        self.out = Dense(cfg.hidden_size, cfg.hidden_size, dtype=dt)
        self.drop = make_dropout(cfg.dropout_impl, cfg.hidden_dropout_prob,
                                 salt=2 if cfg.ring_axis is None else 1)

    def forward(self, x, rng: Optional[DropoutRng] = None, return_probs: bool = False):
        cfg = self.cfg
        b, t, _ = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.heads, cfg.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)   # (B,H,T,D)
        probs = None
        if cfg.ring_axis is not None:
            # context parallelism: K/V blocks ring around the sequence axis
            from ..parallel.ring_attention import ring_attention_local
            out = ring_attention_local(q, k, v, cfg.ring_axis)
        elif return_probs:
            scale = 1.0 / math.sqrt(cfg.head_dim)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            probs = torch.softmax(logits, dim=-1)
            out = torch.matmul(probs.to(v.dtype), v)
        else:
            rate = cfg.attention_probs_dropout_prob
            active = self.training and rate > 0.0
            batch = spmd.batch_frame(b)
            out = attention(q, k, v, dropout_rate=rate, deterministic=not self.training,
                            seed=rng.seed() if active else 0,
                            use_flash=cfg.use_flash_attention, min_seq=cfg.flash_min_seq,
                            draw_bits=rng.bits if active else None,
                            bh_offset=0 if batch is None else batch[0] * self.heads)
        out = out.permute(0, 2, 1, 3).reshape(b, t, self.heads * cfg.head_dim)
        y = self.out(out)
        return self.drop(y, rng, spmd.frame(y.shape)), probs


class Mlp(nn.Module):
    def __init__(self, cfg: VitConfig):
        super().__init__()
        dt = _dtype(cfg)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dt)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dt)
        self.drop1 = make_dropout(cfg.dropout_impl, cfg.hidden_dropout_prob, salt=3)
        self.drop2 = make_dropout(cfg.dropout_impl, cfg.hidden_dropout_prob, salt=4)
        self.tp = False   # the hidden units split over 'model' (Megatron plan)

    def forward(self, x, rng: Optional[DropoutRng] = None):
        h = F.gelu(self.fc1(x), approximate='none')
        h = self.drop1(h, rng, spmd.frame(h.shape, model_dim=-1 if self.tp else None))
        y = self.fc2(h)
        return self.drop2(y, rng, spmd.frame(y.shape))


class Block(nn.Module):
    """Pre-norm transformer block; its MLP is a ``MoeMlp`` when ``use_moe``.
    ``forward`` returns (x, attention probabilities or None, MoE aux loss or
    None)."""

    def __init__(self, cfg: VitConfig, use_moe: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(cfg.hidden_size)
        self.attn = SelfAttention(cfg)
        self.norm2 = LayerNorm(cfg.hidden_size)
        if use_moe:
            self.moe = MoeMlp(cfg, _dtype(cfg))
        else:
            self.mlp = Mlp(cfg)

    def forward(self, x, rng: Optional[DropoutRng] = None, return_probs: bool = False):
        attn_out, probs = self.attn(self.norm1(x), rng, return_probs)
        x = x + attn_out
        if hasattr(self, 'moe'):
            y, aux = self.moe(self.norm2(x), rng)
            return x + y, probs, aux
        return x + self.mlp(self.norm2(x), rng), probs, None


class ScannedBlocks(Block):
    """``num_hidden_layers`` dense blocks with their parameters stacked on a
    leading (L,) axis, under a ``Block``'s names (the JAX ``nn.scan`` tree
    ``encoder/blocks``); layer l runs the block function on the l-th slices
    through a parameterless template (a Linear's int8 stack, when one is
    set, dequantized slice by slice)."""

    def __init__(self, cfg: VitConfig):
        super().__init__(cfg)
        self.layers = cfg.num_hidden_layers
        for name, p in list(self.named_parameters()):
            owner, _, leaf = name.rpartition('.')
            setattr(self.get_submodule(owner), leaf,
                    nn.Parameter(p.new_zeros((self.layers, *p.shape))))
        with torch.device('meta'):
            template = Block(cfg)
        object.__setattr__(self, 'template', template)   # not a submodule

    def layer(self, i: int) -> Callable:
        """Block ``i`` as a function ``(x, rng, return_probs) -> Block's
        outputs``."""
        params = {}
        for name, p in self.named_parameters():
            owner, _, leaf = name.rpartition('.')
            q = getattr(self.get_submodule(owner), 'int8', None) if leaf == 'weight' else None
            params[name] = p[i] if q is None else q[0][i].float() * q[1][i]

        def run(x, rng=None, return_probs=False):
            self.template.train(self.training)
            return torch.func.functional_call(self.template, params, (x, rng, return_probs))
        return run


def _replaying(fn: Callable, rng: Optional[DropoutRng]) -> Callable:
    """``fn`` for ``torch.utils.checkpoint``: its first call runs as it is;
    a recompute runs with the generators of ``rng`` in their state before
    the first call, then gives them back the state it found them in, even
    when the checkpoint stops the recompute early.

    Under a step tape (``rng.tape`` set; a CUDA graph may be capturing, and
    a capture can neither read nor set a generator's state) no generator is
    touched: the recompute reads the tape from the first call's cursor, and
    takes the first call's mask and raw-bit draws back as they were drawn
    (``DropoutRng.saved``), so it sees the same bits; they stay alive until
    the backward, as the masks of a block without remat do."""
    if rng is None:
        return fn
    if rng.tape is not None:
        return _replaying_taped(fn, rng)
    before = (rng.host.get_state(), rng.device.get_state())
    calls = []

    def run(*args):
        if not calls:
            calls.append(1)
            return fn(*args)
        now = (rng.host.get_state(), rng.device.get_state())
        rng.host.set_state(before[0])
        rng.device.set_state(before[1])
        try:
            return fn(*args)
        finally:
            rng.host.set_state(now[0])
            rng.device.set_state(now[1])
    return run


def _replaying_taped(fn: Callable, rng: DropoutRng) -> Callable:
    """:func:`_replaying` under a step tape."""
    cursor, saved, calls = rng.cursor, [], []

    def run(*args):
        first = not calls
        calls.append(1)
        now = rng.cursor
        if not first:
            rng.cursor = cursor
        rng.saved, rng.replay = saved, (None if first else 0)
        try:
            return fn(*args)
        finally:
            rng.saved, rng.replay = None, None
            if not first:
                rng.cursor = now
    return run


def seeds_per_forward(cfg: VitConfig) -> int:
    """How many seeds a training forward of the encoder takes from
    ``DropoutRng.seed``: every hashed dropout site with a non-zero rate (the
    embedding at the attention rate; a block's attention output and its
    MLP's or MoE's two at the hidden rate) and, with attention dropout on,
    each block's attention seed, which is drawn on the flash and the plain
    path alike (the ring path takes none)."""
    hashed = cfg.dropout_impl == 'hash'
    attn = cfg.attention_probs_dropout_prob > 0.0
    hidden = cfg.hidden_dropout_prob > 0.0
    per_block = int(attn and cfg.ring_axis is None) + 3 * int(hashed and hidden)
    return int(hashed and attn) + cfg.num_hidden_layers * per_block


class EcgVitEncoder(nn.Module):
    """Patch embed + cls token + pos emb + transformer stack + final norm."""

    def __init__(self, cfg: VitConfig):
        super().__init__()
        if cfg.moe_num_experts > 0 and cfg.scan_blocks:
            raise ValueError('MoE blocks differ per layer and scan_blocks needs identical '
                             'layers: use the unrolled stack for MoE models')
        self.cfg = cfg
        self.patch_embed = PatchEmbed1D(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, cfg.hidden_size))
        self.emb_drop = make_dropout(cfg.dropout_impl, cfg.attention_probs_dropout_prob,
                                     salt=5)
        if cfg.scan_blocks:
            self.blocks = ScannedBlocks(cfg)
        else:
            self.blocks = nn.ModuleList(Block(cfg, use_moe=moe_layer(cfg, i))
                                        for i in range(cfg.num_hidden_layers))
        self.final_norm = LayerNorm(cfg.hidden_size)

    def forward(self, x, rng: Optional[DropoutRng] = None,
                return_attention: bool = False):
        """(h, the attention maps (L, B, H, T, T) when ``return_attention``
        else None, the mean MoE aux loss).  Each block runs under remat when
        ``cfg.remat`` and gradients are on."""
        h = self.patch_embed(x)
        b, n_patch, hidden = h.shape
        cls = self.cls_token.expand(b, 1, hidden).to(h.dtype)
        h = torch.cat([cls, h], dim=1)
        h = h + self.pos_embed[:, :n_patch + 1].to(h.dtype)
        h = self.emb_drop(h, rng, spmd.frame(h.shape))
        blocks = self.blocks
        layers = ([blocks.layer(i) for i in range(blocks.layers)]
                  if isinstance(blocks, ScannedBlocks) else list(blocks))
        remat = self.cfg.remat and not return_attention and torch.is_grad_enabled()
        maps, auxes = [], []
        for block in layers:
            if remat:
                h, probs, aux = checkpoint(_replaying(block, rng), h, rng,
                                           use_reentrant=False, preserve_rng_state=False)
            else:
                h, probs, aux = block(h, rng, return_attention)
            maps.append(probs)
            if aux is not None:
                auxes.append(aux)
        h = self.final_norm(h)
        return (h, torch.stack(maps, dim=0) if return_attention else None,
                mean_aux(auxes, h.device))


@dataclasses.dataclass
class VitOutput:
    """Mirrors the reference ``ModelOutput(loss, logits)``."""
    logits: torch.Tensor
    loss: Optional[torch.Tensor] = None
    attention: Optional[torch.Tensor] = None
    aux_loss: Optional[torch.Tensor] = None   # mean MoE aux loss (0 when dense)


class EcgVit(nn.Module):
    """Supervised multi-label classifier (reference EcgVit, ecg_vit.py:95-149)."""

    def __init__(self, cfg: VitConfig):
        super().__init__()
        if cfg.pool not in ('cls', 'mean'):
            raise ValueError(f"pool must be 'cls' or 'mean', got {cfg.pool!r}")
        self.cfg = cfg
        self.encoder = EcgVitEncoder(cfg)
        self.head = Dense(cfg.hidden_size, cfg.num_class)      # f32

    def forward(self, sample_values, labels=None, loss_reduction: str = 'mean',
                loss_weight=None, return_attention: bool = False,
                rng: Optional[DropoutRng] = None) -> VitOutput:
        """Logits (and the BCE loss when ``labels`` are given).  In train
        mode every active dropout site draws from ``rng``."""
        cfg = self.cfg
        if (self.training and rng is None
                and max(cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob) > 0):
            raise ValueError('a training forward with dropout needs rng=DropoutRng(...)')
        h, attn, aux = self.encoder(sample_values, rng, return_attention)
        pooled = h[:, 0] if cfg.pool == 'cls' else h.mean(dim=1)
        logits = self.head(pooled.float())
        loss = None
        if labels is not None:
            loss = bce_with_logits(logits, labels, reduction=loss_reduction,
                                   weight=loss_weight)
        return VitOutput(logits=logits, loss=loss, attention=attn, aux_loss=aux)


def bce_with_logits(logits, labels, reduction: str = 'mean', weight=None):
    """BCEWithLogitsLoss (reference ecg_vit.py:118, 140-149).

    ``weight``: optional length-2 (w_neg, w_pos) applied per element by label
    value (a tensor on the logits' device is used as it is).  ``reduction``:
    'mean' | 'none' -- 'none' averages per sample over classes.
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


def stack_unrolled_state_dict(state_dict: Mapping[str, torch.Tensor],
                              num_layers: int) -> Dict[str, torch.Tensor]:
    """An unrolled ``EcgVit`` state_dict (``encoder.blocks.i.*``) -> the
    ``scan_blocks=True`` layout (``encoder.blocks.*`` with a leading (L,)
    axis); the JAX ``stack_unrolled_params``."""
    pre = 'encoder.blocks.'
    out = {k: v for k, v in state_dict.items() if not k.startswith(pre)}
    names = [k[len(f'{pre}0.'):] for k in state_dict if k.startswith(f'{pre}0.')]
    for name in names:
        out[pre + name] = torch.stack([state_dict[f'{pre}{i}.{name}']
                                       for i in range(num_layers)])
    return out


def unstack_scanned_state_dict(state_dict: Mapping[str, torch.Tensor],
                               num_layers: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_unrolled_state_dict`: a ``scan_blocks=True``
    state_dict -> the unrolled layout; the JAX ``unstack_scanned_params``."""
    pre = 'encoder.blocks.'
    out = {k: v for k, v in state_dict.items() if not k.startswith(pre)}
    for key, val in state_dict.items():
        if key.startswith(pre):
            for i in range(num_layers):
                out[f'{pre}{i}.{key[len(pre):]}'] = val[i]
    return out
