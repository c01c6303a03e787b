"""Contrastive (SimCLR-style) model and NT-Xent loss (the JAX
``models/contrastive.py``).

The trunk is the same ``EcgVitEncoder`` the classifier uses, under the same
name ``encoder``, so the transfer into ``EcgVit`` copies it as it is
(train/contrastive.py).  The projection head is a 2-layer MLP: ``proj_fc1``
in the model dtype with the exact GELU, ``proj_fc2`` and the L2
normalisation in f32.  The trunk takes the encoder's options (MoE blocks,
``remat``, ``scan_blocks``); ``forward(..., return_aux=True)`` also returns
its mean MoE aux loss.  NT-Xent takes the (2B, 2B) similarity as one f32
product (JAX computes it outside Pallas, at HIGHEST precision).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import ContrastiveConfig, VitConfig
from ..ops.dropout import DropoutRng
from .vit import Dense, EcgVitEncoder, _dtype


class EcgContrastive(nn.Module):
    """Shared ViT trunk + projection head: unit-norm projections of a batch
    of (already augmented) views."""

    def __init__(self, cfg: VitConfig, con_cfg: ContrastiveConfig):
        super().__init__()
        cfg.require_vit_block('contrastive pretraining (models/contrastive.py)')
        self.cfg, self.con_cfg = cfg, con_cfg
        self.encoder = EcgVitEncoder(cfg)
        self.proj_fc1 = Dense(cfg.hidden_size, con_cfg.proj_hidden_size, dtype=_dtype(cfg))
        self.proj_fc2 = Dense(con_cfg.proj_hidden_size, con_cfg.proj_dim,
                              dtype=torch.float32)

    def forward(self, x, rng: Optional[DropoutRng] = None, return_aux: bool = False):
        """The unit-norm projections (2B, proj_dim); with ``return_aux``
        also the trunk's mean MoE aux loss (0 when dense)."""
        h, _, aux = self.encoder(x, rng)
        pooled = h[:, 0] if self.cfg.pool == 'cls' else h.mean(dim=1)
        z = F.gelu(self.proj_fc1(pooled), approximate='none')
        z = self.proj_fc2(z.float())
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp(min=1e-8)
        return (z, aux) if return_aux else z


def nt_xent(z: torch.Tensor, temperature: float = 0.1, with_accuracy: bool = False):
    """Normalized-temperature cross entropy over paired views.

    ``z``: (2B, d) unit-norm projections laid out [views_a; views_b]: row i
    and row (i + B) mod 2B are a positive pair.  Returns the mean InfoNCE
    loss over the 2B anchors and, with ``with_accuracy``, the top-1
    retrieval accuracy (argmax takes the first of tied maxima)."""
    z = z.float()
    n = z.shape[0]
    sim = torch.matmul(z, z.T) / torch.full((), temperature, device=z.device)
    diag = torch.eye(n, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(diag, float('-inf'))               # self is not a pair
    pos_idx = (torch.arange(n, device=z.device) + n // 2) % n
    logprob = torch.log_softmax(sim, dim=-1)
    loss = -logprob.gather(1, pos_idx[:, None]).mean()
    if not with_accuracy:
        return loss
    acc = (torch.argmax(sim, dim=-1) == pos_idx).float().mean()
    return loss, acc
