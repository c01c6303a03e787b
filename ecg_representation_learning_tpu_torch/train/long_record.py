"""Long-record masked-signal pretraining with context parallelism (the JAX
package's ``train/long_record.py``).

  * masked-signal modelling with in-place mask tokens (SimMIM-style) rather
    than the MAE's gather of visible patches -- the gather would move
    patches across sequence shards, while mask tokens keep every shard's
    token count fixed and local;
  * the encoder is ``EcgVit``'s ``Block`` stack with ``VitConfig.ring_axis``
    set, so attention runs ring-sharded over the mesh
    (``parallel/ring_attention.py``) and everything else is token-local;
  * each rank holds one sequence shard of the signals and the mask, adds
    its slice of the global position embedding (offset rank * P_local),
    and returns (masked-MSE sum, masked count); the step sums both over the
    axis (``spmd.sum_over``: the sum forward, the identity backward, JAX's
    ``psum``), and the replicated parameters' gradients are summed over the
    axis (``spmd.sum_grads``, the transpose of JAX's replicated input), so
    each rank takes the one-device update;
  * the mask is drawn for the global (B, P) batch with exactly ``n_mask``
    ones per row from a generator every rank holds in the same state, then
    cut to the rank's patches.

The train state is (step, parameters, optimizer state, mask generator):
step-tagged checkpoints (rank 0 writes, every rank reads), pruning to the
newest two, and a resume that skips the batches already consumed, so a
deterministic stream continues as an uninterrupted run would.  As in JAX
the step runs the model deterministically (no dropout) and keeps no EMA.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import TrainConfig, VitConfig
from ..models.mae import patchify
from ..models.vit import Block, Dense, LayerNorm, PatchEmbed1D
from ..parallel import spmd
from .optim import make_optimizer


class EcgMim(nn.Module):
    """Masked-signal-modelling trunk over one sequence shard.

    ``x`` (B, C, L_local) and ``mask`` (B, P_local, 1 = masked) are the
    shard's; ``pos_offset`` is its first patch's global index.  Returns
    (masked-MSE sum, masked count) for the caller to sum over the shards.
    Module names are the flax tree's (``block_i`` <-> ``blocks.i``)."""

    def __init__(self, cfg: VitConfig):
        super().__init__()
        cfg.require_vit_block('ring attention (train/long_record.py)')
        self.cfg = cfg
        self.patch_embed = PatchEmbed1D(cfg)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches, cfg.hidden_size))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_hidden_layers))
        self.final_norm = LayerNorm(cfg.hidden_size)
        self.pred = Dense(cfg.hidden_size, cfg.num_channels * cfg.patch_size)   # f32

    def forward(self, x: torch.Tensor, mask: torch.Tensor, pos_offset: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        p_local = x.shape[-1] // cfg.patch_size
        h = self.patch_embed(x)                                    # (B, P_local, H)
        h = torch.where(mask[..., None] > 0, self.mask_token.to(h.dtype), h)
        h = h + self.pos_embed[:, pos_offset:pos_offset + p_local].to(h.dtype)
        for block in self.blocks:
            h, _, _ = block(h)
        h = self.final_norm(h)
        pred = self.pred(h.float())

        target = patchify(x, cfg.patch_size).float()
        mu = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=0)
        target = (target - mu) / torch.sqrt(var + 1e-6)
        per_patch = ((pred - target) ** 2).mean(dim=-1)            # (B, P_local)
        return (per_patch * mask).sum(), mask.sum()


def _exact_count_mask(generator: torch.Generator, batch: int, n_patches: int, n_mask: int,
                      device=None) -> torch.Tensor:
    """(batch, n_patches) f32 mask with exactly ``n_mask`` ones per row
    (ties aside): rank a uniform draw per row and mask its ``n_mask``
    smallest entries."""
    u = torch.rand((batch, n_patches), generator=generator, device=device)
    kth = torch.sort(u, dim=1).values[:, n_mask - 1:n_mask]
    return (u <= kth).float()


class RingPretrainer:
    """Context-parallel masked-signal pretrainer: the sequence split over
    ``seq_axis`` of ``mesh`` (``parallel.make_mesh``; one rank per shard),
    ring attention inside, parameters replicated."""

    def __init__(self, model_cfg: VitConfig, train_cfg: TrainConfig, mesh,
                 seq_axis: str = 'data', mask_ratio: float = 0.5, total_steps: int = 1000,
                 output_dir: Optional[str] = None):
        if model_cfg.ring_axis != seq_axis:
            raise ValueError('set VitConfig.ring_axis to the sequence mesh axis')
        self.cfg, self.train_cfg = model_cfg, train_cfg
        self.mesh, self.seq_axis = mesh, seq_axis
        self.n_shards = mesh.shape[seq_axis]
        self.index = mesh.index(seq_axis) if self.n_shards > 1 else 0
        if model_cfg.max_signal_length % (model_cfg.patch_size * self.n_shards):
            raise ValueError(f'max_signal_length {model_cfg.max_signal_length} does not split '
                             f'into {self.n_shards} shards of whole patches')
        self.mask_ratio = mask_ratio
        self.device = mesh.device
        self.model = EcgMim(model_cfg).to(self.device).eval()   # deterministic, as in JAX
        self.optimizer, self.schedule = make_optimizer(train_cfg, total_steps)
        self.output_dir = output_dir or os.path.join('runs', 'ring-cp')
        self.step = 0
        self.opt_state = None
        self.generator: Optional[torch.Generator] = None

    # ------------------------------------------------------------------ state
    def _leaves(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def init(self, seed: int = 0):
        """Seeded init (``flax_init_``; the ring path builds without a live
        axis, so the model is its own ring-free twin); fresh optimizer
        state, step 0 and the mask generator from ``seed``."""
        from .trainer import flax_init_
        self.model.to('cpu')
        flax_init_(self.model, seed)
        self.model.to(self.device)
        self.opt_state = self.optimizer.init(self._leaves())
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(np.random.SeedSequence([seed, 1]).generate_state(
            1, np.uint64)[0] >> 2))
        self.step = 0
        return self.state_dict()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def set_params(self, state_dict) -> None:
        """Install parameters (e.g. flax ones through ``models.port``),
        re-initializing the optimizer state."""
        if self.opt_state is None:
            self.init()
        self.model.load_state_dict(state_dict, strict=True)
        self.opt_state = self.optimizer.init(self._leaves())

    # ------------------------------------------------------------------- step
    def draw_mask(self, batch: int) -> torch.Tensor:
        """The global (batch, P) mask of the next step, from the generator
        every rank holds in the same state."""
        n_patches = self.cfg.num_patches
        n_mask = max(1, int(round(n_patches * self.mask_ratio)))
        return _exact_count_mask(self.generator, batch, n_patches, n_mask, self.device)

    def loss_and_grads(self, x, mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The global loss (a 0-d device tensor) of the batch ``x`` (B, C,
        max_signal_length) and every parameter's gradient summed over the
        axis -- what one device computes on the whole records -- without an
        update.  The rank takes its sequence shard of ``x`` and of ``mask``
        (default: the next drawn mask)."""
        if self.opt_state is None:
            raise RuntimeError('call init() or load_checkpoint() first')
        cfg, axis = self.cfg, self.seq_axis
        l_local = cfg.max_signal_length // self.n_shards
        p_local = cfg.num_patches // self.n_shards
        x = torch.as_tensor(x, dtype=torch.float32)
        mask = self.draw_mask(x.shape[0]) if mask is None else torch.as_tensor(mask)
        i = self.index
        x_loc = x[:, :, i * l_local:(i + 1) * l_local].to(self.device)
        m_loc = mask[:, i * p_local:(i + 1) * p_local].to(self.device, torch.float32)
        params = dict(self.model.named_parameters())
        for p in params.values():
            p.grad = None
        with spmd.mesh_context(self.mesh):
            loss_sum, cnt = self.model(x_loc, m_loc, i * p_local)
            total = spmd.sum_over(loss_sum, axis)
            cnt = spmd.sum_over(cnt.detach(), axis)
        loss = total / torch.clamp(cnt, min=1.0)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        spmd.sum_grads(list(grads.values()), axis, self.mesh)
        return loss.detach(), grads

    def train_step(self, x, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step on the global batch ``x`` (``loss_and_grads``, then the
        update).  Returns the global loss (a 0-d device tensor)."""
        loss, grads = self.loss_and_grads(x, mask)
        self.opt_state = self.optimizer.apply(grads, self.opt_state, self._leaves())
        self.step += 1
        return loss

    # ------------------------------------------------------------ checkpoints
    def _is_writer(self) -> bool:
        import torch.distributed as dist
        return not dist.is_initialized() or dist.get_rank() == 0

    def _barrier(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.barrier()

    def save_checkpoint(self, tag: Optional[str] = None) -> str:
        """Step-tagged save (``ckpt-step{N}``) into a fresh path, so a crash
        mid-write never deletes the previous committed checkpoint.  Rank 0
        writes; every rank returns the path."""
        from .checkpoint import save_checkpoint
        tag = tag or f'step{self.step}'
        path = os.path.join(os.path.abspath(self.output_dir), f'ckpt-{tag}')
        state = {'step': self.step, 'params': self.state_dict(),
                 'opt_state': {'count': self.opt_state.count, 'mu': self.opt_state.mu,
                               'nu': self.opt_state.nu},
                 'rng': {'mask': self.generator.get_state()}}
        if self._is_writer():
            save_checkpoint(path, state, async_save=self.train_cfg.async_checkpoint)
        self._barrier()
        return path

    def latest_checkpoint(self) -> Optional[str]:
        from .checkpoint import latest_committed_checkpoint, wait_for_checkpoints
        if self._is_writer():
            wait_for_checkpoints()
        self._barrier()
        return latest_committed_checkpoint(self.output_dir)

    def _prune_checkpoints(self, keep: int = 2) -> None:
        """Drop all but the newest ``keep`` committed step-tagged checkpoints
        (rank 0; an async save in flight is tmp-named, never a target)."""
        from .checkpoint import prune_checkpoints
        if self._is_writer():
            prune_checkpoints(self.output_dir, keep=keep)

    def load_checkpoint(self, path: str):
        from .checkpoint import restore_checkpoint
        if self.opt_state is None:
            self.init()
        raw = restore_checkpoint(path)
        self.model.load_state_dict(raw['params'], strict=True)
        opt = raw['opt_state']
        self.opt_state = dataclasses.replace(
            self.opt_state, count=int(opt['count']),
            mu={k: v.to(self.device) for k, v in opt['mu'].items()},
            nu={k: v.to(self.device) for k, v in opt['nu'].items()})
        if 'rng' in raw:   # a checkpoint converted from JAX carries none
            self.generator.set_state(raw['rng']['mask'])
        self.step = int(raw['step'])
        return self.state_dict()

    # ------------------------------------------------------------------- loop
    def train(self, batches: Iterable, steps: int, seed: int = 0, ckpt_every: int = 0,
              resume: bool = False) -> Dict[str, Any]:
        """``batches``: an iterator of (B, C, max_signal_length) arrays (e.g.
        a ``data.pipeline.ShardedRecordStream``), the same on every rank.
        ``ckpt_every`` saves every N steps; ``resume=True`` restores the
        latest checkpoint and skips the batches it consumed."""
        from .checkpoint import wait_for_checkpoints
        start_step = 0
        if resume:
            path = self.latest_checkpoint()
            if path:
                self.load_checkpoint(path)
                start_step = self.step
        if self.opt_state is None:
            self.init(seed)
        if ckpt_every:
            os.makedirs(self.output_dir, exist_ok=True)
        losses = []
        host_step = start_step
        saved_at = -1
        for x in itertools.islice(iter(batches), start_step, steps):
            losses.append(float(self.train_step(np.asarray(x, np.float32))))
            host_step += 1
            if ckpt_every and host_step % ckpt_every == 0:
                self.save_checkpoint(tag=f'step{host_step}')
                self._prune_checkpoints()
                saved_at = host_step
        if ckpt_every and host_step != saved_at:
            self.save_checkpoint(tag=f'step{host_step}')
            self._prune_checkpoints()
        if self.train_cfg.async_checkpoint and self._is_writer():
            wait_for_checkpoints()   # durable before returning
        self._barrier()
        return {'losses': losses, 'loss': losses[-1] if losses else None, 'steps': host_step}
