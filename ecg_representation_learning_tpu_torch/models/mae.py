"""Masked-autoencoder pretraining for ECG (the JAX ``models/mae.py``).

75 % of the (12 x 64)-sample patches are masked, the encoder (the blocks of
``EcgVit``, without a cls token) sees only the visible patches, and a light
decoder reconstructs the masked ones under MSE (He et al. 2022, on 1-D
signals).  The mask is a per-sample argsort of uniform noise with a static
visible count, so every shape is known before the forward.

Module names keep the flax tree's: a flat ``encoder_*`` trunk
(``encoder_patch_embed``, ``encoder_pos_embed``, ``encoder_blocks.i`` for
``encoder_block_i``, ``encoder_norm``) and ``decoder`` (``embed``,
``mask_token``, ``pos_embed``, ``blocks.i``, ``norm``, ``pred``), so
``models/port.py`` maps the weights by path and a checkpoint's top-level
names tell an MAE trunk from a contrastive one (train/contrastive.py).

With ``moe_num_experts > 0`` the encoder blocks follow the trunk's MoE
placement rule (``encoder_block_i`` is a Switch-MoE block when (i + 1) %
``moe_every`` == 0), so a Switch trunk pretrains with its experts live and
transfers layer for layer; the decoder stays dense, and ``MaeOutput.aux_loss``
carries the encoder's mean aux loss.  As in JAX, the MAE's own stack takes
neither ``remat`` nor ``scan_blocks``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..configs import MaeConfig, VitConfig
from ..ops.dropout import DropoutRng
from ..parallel import spmd
from .moe import mean_aux, moe_layer
from .vit import Block, Dense, LayerNorm, PatchEmbed1D, _dtype


@dataclasses.dataclass
class MaeOutput:
    loss: torch.Tensor
    pred: torch.Tensor               # (B, P, C*patch) reconstructed patches, f32
    mask: torch.Tensor               # (B, P) 1 = masked (reconstructed), 0 = visible
    ids_restore: torch.Tensor
    per_sample_loss: Optional[torch.Tensor] = None  # (B,) masked MSE per sample
    aux_loss: Optional[torch.Tensor] = None   # mean MoE aux loss of the encoder (0 when dense)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, C, L) -> (B, P, C*patch), PatchEmbed1D's channel-major layout."""
    b, c, length = x.shape
    p = length // patch_size
    return x.reshape(b, c, p, patch_size).permute(0, 2, 1, 3).reshape(b, p, c * patch_size)


def unpatchify(patches: torch.Tensor, num_channels: int, patch_size: int) -> torch.Tensor:
    b, p, _ = patches.shape
    x = patches.reshape(b, p, num_channels, patch_size).permute(0, 2, 1, 3)
    return x.reshape(b, num_channels, p * patch_size)


def visible_count(n_patch: int, mask_ratio: float) -> int:
    return max(1, int(round(n_patch * (1.0 - mask_ratio))))


def random_masking(batch: int, n_patch: int, mask_ratio: float,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample random patch permutation with a static visible count.

    ``noise`` (B, P) uniform [0, 1) is drawn from ``generator`` when not
    given.  The sorts are stable, as ``jnp.argsort``.  Returns (ids_keep
    (B, V), ids_restore (B, P), mask (B, P) f32)."""
    len_keep = visible_count(n_patch, mask_ratio)
    if noise is None:
        noise = torch.rand((batch, n_patch), generator=generator, device=device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    mask = torch.ones((batch, n_patch), device=noise.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return ids_keep, ids_restore, mask


def _gather_rows(h: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """h[b, ids[b, i], :] -- ``take_along_axis`` over the token axis."""
    return torch.gather(h, 1, ids[:, :, None].expand(-1, -1, h.shape[-1]))


def decoder_config(cfg: VitConfig, mae: MaeConfig) -> VitConfig:
    """The decoder blocks' config: the trunk's with the decoder's widths."""
    return dataclasses.replace(cfg, hidden_size=mae.decoder_hidden_size,
                               num_hidden_layers=mae.decoder_num_layers,
                               num_attention_heads=mae.decoder_num_heads,
                               intermediate_size=mae.decoder_intermediate_size)


class MaeDecoder(nn.Module):
    def __init__(self, cfg: VitConfig, mae: MaeConfig):
        super().__init__()
        self.cfg, self.mae = cfg, mae
        d = mae.decoder_hidden_size
        self.embed = Dense(cfg.hidden_size, d, dtype=_dtype(cfg))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.max_signal_length // cfg.patch_size, d))
        dec_cfg = decoder_config(cfg, mae)
        self.blocks = nn.ModuleList(Block(dec_cfg) for _ in range(mae.decoder_num_layers))
        self.norm = LayerNorm(d)
        self.pred = Dense(d, cfg.num_channels * cfg.patch_size, dtype=torch.float32)

    def forward(self, h_visible, ids_restore, rng: Optional[DropoutRng] = None):
        b, v, _ = h_visible.shape
        p = ids_restore.shape[1]
        h = self.embed(h_visible)
        mask_tokens = self.mask_token.expand(b, p - v, -1).to(h.dtype)
        h_full = _gather_rows(torch.cat([h, mask_tokens], dim=1), ids_restore)
        h_full = h_full + self.pos_embed[:, :p].to(h_full.dtype)
        for block in self.blocks:
            h_full, _, _ = block(h_full, rng)
        return self.pred(self.norm(h_full).float())


class EcgMae(nn.Module):
    """Masked-patch pretrainer over the ``EcgVit`` blocks."""

    def __init__(self, cfg: VitConfig, mae: MaeConfig = MaeConfig()):
        super().__init__()
        cfg.require_vit_block('the MAE (models/mae.py)')
        if cfg.ring_axis is not None:
            raise NotImplementedError('ring_axis: the MAE gathers visible patches across the '
                                      'sequence, which a sequence split over ranks cannot '
                                      'do; pretrain long records with train.long_record.EcgMim')
        self.cfg, self.mae = cfg, mae
        self.encoder_patch_embed = PatchEmbed1D(cfg)
        self.encoder_pos_embed = nn.Parameter(
            torch.zeros(1, cfg.max_signal_length // cfg.patch_size, cfg.hidden_size))
        self.encoder_blocks = nn.ModuleList(Block(cfg, use_moe=moe_layer(cfg, i))
                                            for i in range(cfg.num_hidden_layers))
        self.encoder_norm = LayerNorm(cfg.hidden_size)
        self.decoder = MaeDecoder(cfg, mae)

    def forward(self, sample_values, rng: Optional[DropoutRng] = None,
                noise: Optional[torch.Tensor] = None) -> MaeOutput:
        """Masked reconstruction loss of (B, C, L) signals.  The mask comes
        from ``noise`` (B, P) when given, else from ``rng.device``.  In train
        mode every active dropout site draws from ``rng``."""
        cfg, mae = self.cfg, self.mae
        b, _, length = sample_values.shape
        n_patch = length // cfg.patch_size
        if noise is None and rng is None:
            raise ValueError('EcgMae needs noise= or rng= for the mask')
        if noise is None:   # on a mesh: the global batch's draw, this rank's rows
            noise = spmd.global_draw(b, lambda n: torch.rand(
                (n, n_patch), generator=rng.device, device=sample_values.device))
        ids_keep, ids_restore, mask = random_masking(
            b, n_patch, mae.mask_ratio, noise=noise,
            generator=None if rng is None else rng.device, device=sample_values.device)

        h = self.encoder_patch_embed(sample_values)                 # (B, P, H)
        h = h + self.encoder_pos_embed[:, :n_patch].to(h.dtype)
        h = _gather_rows(h, ids_keep)                               # (B, V, H)
        auxes = []
        for block in self.encoder_blocks:
            h, _, aux = block(h, rng)
            if aux is not None:
                auxes.append(aux)
        h = self.encoder_norm(h)

        pred = self.decoder(h, ids_restore, rng)

        target = patchify(sample_values, cfg.patch_size).float()
        if mae.norm_patch_targets:
            mu = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=0)
            target = (target - mu) / torch.sqrt(var + 1e-6)
        per_patch = ((pred - target) ** 2).mean(dim=-1)             # (B, P)
        loss = (per_patch * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        per_sample = (per_patch * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
        return MaeOutput(loss=loss, pred=pred, mask=mask, ids_restore=ids_restore,
                         per_sample_loss=per_sample, aux_loss=mean_aux(auxes, h.device))
