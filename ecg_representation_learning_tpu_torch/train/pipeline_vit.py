"""Pipeline-parallel training of ``EcgVit`` (the JAX package's
``train/pipeline_vit.py``; ``TrainConfig.mesh_stage``, ``cli train
--mesh-stage``).

  * the transformer stack (the ``scan_blocks`` layout, (L, ...) stacks) is
    split over the 'stage' axis of a ('data', 'stage') mesh: a rank holds
    its L / S layers (its stage model is ``EcgVit`` with L / S scanned
    layers) and the boundary -- patch embedding, cls and position
    embeddings, final norm, head -- which every rank keeps whole, as JAX
    keeps it replicated over 'stage';
  * the forward (``pipeline_vit_forward``) is ``EcgVitEncoder``'s
    boundary maths around ``parallel.pipeline_apply``, the embedding-site
    dropout included (salt 5, its hashed mask indexed in the global batch);
  * data parallelism: the batch is cut into M microbatches and each data
    rank takes its slice of every microbatch (JAX's ``P(None, 'data')``:
    ``data_rows``), runs its own pipeline, and the gradients are averaged
    over 'data';
  * gradients as JAX's: the last stage computes the loss, so the head's
    and final norm's gradients exist there and the patch embedding's on
    stage 0; the boundary gradients are summed over 'stage' and every
    gradient is averaged over 'data' -- one all-reduce each -- then the
    update tail runs with the mesh-wide norm (``ops.adamw.NormReduce``: a
    stage leaf has n_data copies, a boundary leaf n_data * n_stage);
  * checkpoints and ``merged_params`` gather the full stacks over 'stage',
    so a file is the one-device ``scan_blocks`` file whatever the mesh;
    evaluation runs the merged parameters in a one-device ``Trainer``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import TrainConfig, VitConfig
from ..models.vit import EcgVit, bce_with_logits
from ..ops.augment import timeout as timeout_op, timeout_draws
from ..ops.dropout import DropoutRng
from ..ops.normalize import normalize_fixed
from ..ops.pad import time_end_pad
from ..parallel.mesh import DATA_AXIS, STAGE_AXIS, make_pp_mesh, stage_norm_weights
from ..parallel.pipeline_parallel import pipeline_apply, stack_stage_params
from ..parallel import spmd
from ..utils.logging import get_logger
from .optim import make_optimizer

_BLOCKS = 'encoder.blocks.'


def split_vit_params(state_dict: Mapping[str, torch.Tensor], n_stage: int
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """An ``EcgVit(scan_blocks=True)`` state_dict -> (outer, stages):
    ``outer`` everything but the block stack, ``stages`` the stack's leaves
    (by their ``Block`` names) reshaped (S, L / S, ...)."""
    outer = {k: v for k, v in state_dict.items() if not k.startswith(_BLOCKS)}
    blocks = {k[len(_BLOCKS):]: v for k, v in state_dict.items() if k.startswith(_BLOCKS)}
    return outer, stack_stage_params(blocks, n_stage)


def merge_vit_params(outer: Mapping[str, torch.Tensor], stages: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_vit_params`."""
    out = dict(outer)
    out.update({_BLOCKS + k: v.reshape(-1, *v.shape[2:]) for k, v in stages.items()})
    return out


def data_rows(batch: int, n_micro: int, mesh) -> np.ndarray:
    """The global rows this rank's data index holds, microbatch by
    microbatch: of each microbatch of batch / n_micro rows, its slice of
    the data axis (JAX's ``P(None, 'data')`` over (M, B / M, ...))."""
    if batch % n_micro:
        raise ValueError(f'batch {batch} does not split into {n_micro} microbatches')
    d, n_data = spmd.axis_index(DATA_AXIS, mesh)
    per_micro = batch // n_micro
    if per_micro % n_data:
        raise ValueError(f'a microbatch of {per_micro} rows does not split over '
                         f'{n_data} data ranks')
    local = per_micro // n_data
    return (np.arange(n_micro)[:, None] * per_micro + d * local
            + np.arange(local)[None, :]).reshape(-1)


def pipeline_vit_forward(cfg: VitConfig, model: EcgVit, sig: torch.Tensor, mesh,
                         n_micro: int, rng: Optional[DropoutRng] = None,
                         rows: Optional[torch.Tensor] = None,
                         batch: Optional[int] = None) -> torch.Tensor:
    """``EcgVit``'s logits with the block stack pipelined over 'stage'.

    ``model``: this rank's stage model (``EcgVit`` with its L / S scanned
    layers and the whole boundary); ``sig``: its rows (``data_rows``) of
    the global batch of ``batch`` rows, normalized, microbatch-major.  In
    train mode with dropout, ``rng`` (host and device generators in the
    same state on every rank; ``mask`` per data rank) seeds the embedding
    site -- its hashed mask indexed by the global ``rows`` -- and the
    pipeline's streams.  Boundary maths as ``EcgVitEncoder.forward``."""
    enc = model.encoder
    h = enc.patch_embed(sig)
    b, n_patch, hidden = h.shape
    cls = enc.cls_token.expand(b, 1, hidden).to(h.dtype)
    h = torch.cat([cls, h], dim=1)
    h = h + enc.pos_embed[:, :n_patch + 1].to(h.dtype)
    dropout = model.training and rng is not None
    if dropout:
        frame = None if rows is None else {0: (rows, batch)}
        h = enc.emb_drop(h, rng, frame)
    t = n_patch + 1
    if b % n_micro:
        raise ValueError(f'{b} rows do not split into {n_micro} microbatches')
    blocks = enc.blocks
    template, training = blocks.template, blocks.training

    def block_fn(lp, a, layer_rng=None):
        template.train(training)
        return torch.func.functional_call(template, lp, (a, layer_rng))[0]

    stages = dict(blocks.named_parameters())
    h_micro = pipeline_apply(stages, h.reshape(n_micro, b // n_micro, t, hidden), block_fn,
                             mesh, rng=rng.seed() if dropout else None)
    h = enc.final_norm(h_micro.reshape(b, t, hidden))
    pooled = h[:, 0] if cfg.pool == 'cls' else h.mean(dim=1)
    return model.head(pooled.float())


class PipelineVitTrainer:
    """DP x PP training of ``EcgVit`` (``TrainConfig.mesh_stage`` > 1) on a
    ('data', 'stage') mesh: one rank per (data, stage) place, every rank
    calling every method.  The step: the rank's rows -> normalize + pad (+
    TimeOut drawn for the global batch) -> pipelined forward -> BCE -> the
    backward -> gradients summed / averaged -> the AdamW tail with the
    mesh-wide norm and clip.  Evaluation runs the merged parameters on one
    device (the stage split is a storage layout, not a change of
    function)."""

    def __init__(self, model_cfg: VitConfig, train_cfg: TrainConfig,
                 train_data=None, eval_data=None,
                 norm_stats: Optional[Dict[str, Any]] = None,
                 n_micro: Optional[int] = None, output_dir: Optional[str] = None,
                 mesh=None, device=None):
        model_cfg.require_vit_block('the GPipe pipeline (train/pipeline_vit.py)')
        if not model_cfg.scan_blocks:
            raise ValueError('pipeline staging needs the stacked layout (scan_blocks=True)')
        if train_cfg.mesh_stage <= 1:
            raise ValueError('use Trainer for mesh_stage == 1')
        if train_cfg.grad_accum > 1 or train_cfg.ema_decay > 0:
            raise NotImplementedError(
                'grad_accum/ema_decay are not implemented on the pipeline trainer '
                '(microbatching already splits the batch; EMA lives on the plain Trainer) '
                '-- unset them rather than silently ignoring them')
        self.model_cfg, self.cfg = model_cfg, train_cfg
        self.mesh = mesh if mesh is not None else make_pp_mesh(
            train_cfg.mesh_stage, train_cfg.mesh_data or 1, device=device)
        self.device = self.mesh.device
        self.n_stage = self.mesh.shape[STAGE_AXIS]
        self.n_data = self.mesh.shape[DATA_AXIS]
        self.stage = self.mesh.index(STAGE_AXIS)
        layers = model_cfg.num_hidden_layers
        if layers % self.n_stage:
            raise ValueError(f'{layers} layers do not split into {self.n_stage} stages')
        self.model = EcgVit(dataclasses.replace(
            model_cfg, num_hidden_layers=layers // self.n_stage)).to(self.device).eval()
        self.names = [k for k, _ in self.model.named_parameters()]
        self.stage_names = [k for k in self.names if k.startswith(_BLOCKS)]
        self.train_data, self.eval_data = train_data, eval_data
        stats = norm_stats or {'mean': [0.0] * model_cfg.num_channels,
                               'std': [1.0] * model_cfg.num_channels}
        self.mean = torch.tensor(stats['mean'], dtype=torch.float32, device=self.device)
        self.std = torch.tensor(stats['std'], dtype=torch.float32, device=self.device)
        self.n_micro = n_micro or 2 * self.n_stage   # GPipe default
        self.output_dir = output_dir or os.path.join('runs', 'pp')
        n_train = len(train_data) if train_data is not None else 1
        self.total_steps = train_cfg.total_steps(n_train)
        self.optimizer, self.schedule = make_optimizer(train_cfg, self.total_steps)
        from ..ops.adamw import NormReduce
        self._norm_reduce = NormReduce(stage_norm_weights(self.names, self.stage_names,
                                                          self.mesh))
        self.opt_state = None
        self.rng: Optional[DropoutRng] = None
        self._nonfinite = torch.zeros((), dtype=torch.int32, device=self.device)
        self._probe_applied = False
        self._host_step = 0
        self.epoch = 0
        self.logger = get_logger('EcgVit PP Train')
        with torch.device('meta'):
            self._full_shapes = EcgVit(model_cfg).state_dict()

    # ------------------------------------------------------------ parameters
    def _leaves(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def _local(self, full: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full (scan layout) tensors cut to this rank's: the boundary whole,
        the stack's slice of this stage's layers."""
        per = self.model_cfg.num_hidden_layers // self.n_stage
        return {k: (full[k][self.stage * per:(self.stage + 1) * per] if k.startswith(_BLOCKS)
                    else full[k]).contiguous() for k in self.names}

    def _load_full(self, full: Mapping[str, torch.Tensor]) -> None:
        from .checkpoint import check_params
        check_params(full, self._full_shapes, 'params')
        mine = self._local(full)
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(mine[k])

    def _full(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors laid out like the leaves gathered into full (scan layout)
        tensors on the CPU, on every rank (a collective over 'stage')."""
        group = self.mesh.group(STAGE_AXIS)
        on_host = dist.get_backend(group) == 'gloo'
        out = {}
        for k in self.names:
            t = tensors[k].detach()
            if k.startswith(_BLOCKS):
                t = t.to('cpu', copy=True) if on_host else t.contiguous()
                parts = [torch.empty_like(t) for _ in range(self.n_stage)]
                dist.all_gather(parts, t, group=group)
                t = torch.cat(parts, dim=0)
            out[k] = t.to('cpu', copy=True)
        return out

    def merged_params(self) -> Dict[str, torch.Tensor]:
        """The parameters as one ``EcgVit(scan_blocks=True)`` state_dict (a
        collective over 'stage')."""
        return self._full(self._leaves())

    def _finalize_optimizer(self) -> None:
        """The linear probe (head-only updates, the optax chain), once."""
        if self.cfg.linear_probe and not self._probe_applied:
            from .pretrain import make_probe_optimizer
            self.optimizer, self.schedule = make_probe_optimizer(self.cfg, self.total_steps,
                                                                 self.names)
            self._probe_applied = True

    def _reset_optimizer(self) -> None:
        self._finalize_optimizer()
        self.opt_state = self.optimizer.init(self._leaves())

    def init_state(self, seed: Optional[int] = None) -> None:
        """Seeded init of the full model (every rank draws it and keeps its
        part), fresh optimizer state, the generators from the seed."""
        from .trainer import flax_init_
        seed = self.cfg.seed if seed is None else seed
        with torch.device('meta'):
            full = EcgVit(self.model_cfg)
        full = full.to_empty(device='cpu')
        flax_init_(full, seed)
        self._load_full(full.state_dict())
        host = torch.Generator().manual_seed(seed)
        dev = torch.Generator(device=self.device)
        dev.manual_seed(int(torch.randint(0, 1 << 62, (1,), generator=host)))
        mask = torch.Generator(device=self.device)
        mask.manual_seed(int(np.random.SeedSequence(
            [seed, self.mesh.index(DATA_AXIS)]).generate_state(1, np.uint64)[0] >> 2))
        self.rng = DropoutRng(host=host, device=dev, mask=mask)
        self._host_step = 0
        self._reset_optimizer()

    def set_merged_params(self, merged: Mapping[str, torch.Tensor]) -> None:
        """Install a full ``scan_blocks`` state_dict (a ported reference
        checkpoint, a transferred SSL trunk), re-initializing the optimizer
        state."""
        if self.opt_state is None:
            self.init_state()
        self._load_full(merged)
        self._reset_optimizer()

    # ------------------------------------------------------------------- step
    def _batch(self, data, take: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        def rows(x, dtype):
            if isinstance(x, torch.Tensor):
                return x[torch.as_tensor(take, device=x.device)].to(self.device, dtype)
            return torch.from_numpy(np.asarray(x[take], np.float32)).to(self.device, dtype)
        return rows(data.signals, torch.float32), rows(data.labels, torch.float32)

    def train_step(self, data, take: np.ndarray) -> torch.Tensor:
        """One optimizer step on the global batch of rows ``take`` of
        ``data``; returns the global loss (a 0-d device tensor)."""
        if self.opt_state is None:
            raise RuntimeError('call init_state() or set_merged_params() first')
        cfg, model_cfg = self.cfg, self.model_cfg
        batch = len(take)
        rows = data_rows(batch, self.n_micro, self.mesh)
        sig, lab = self._batch(data, np.asarray(take)[rows])
        rows_t = torch.as_tensor(rows, device=self.device)
        sig = time_end_pad(normalize_fixed(sig, self.mean, self.std), model_cfg.patch_size)
        if cfg.augment_timeout:   # drawn for the global batch, the rank's rows kept
            span, start = timeout_draws((batch,), 0.0, 0.5, generator=self.rng.device,
                                        device=self.device)
            sig = timeout_op(sig, 0.0, 0.5, span_draw=span[rows_t], start_draw=start[rows_t])
        sig = sig[..., :model_cfg.max_signal_length]
        dropout_on = (model_cfg.hidden_dropout_prob > 0
                      or model_cfg.attention_probs_dropout_prob > 0)
        params = dict(self.model.named_parameters())
        for p in params.values():
            p.grad = None
        self.model.train(dropout_on)
        logits = pipeline_vit_forward(model_cfg, self.model, sig, self.mesh, self.n_micro,
                                      rng=self.rng if dropout_on else None, rows=rows_t,
                                      batch=batch)
        self.model.eval()
        loss = bce_with_logits(logits, lab, weight=cfg.loss_weight)
        # the last stage's loss is the loss; every rank runs the backward
        (loss * float(self.stage == self.n_stage - 1)).backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        spmd.sum_grads([grads[k] for k in self.names], DATA_AXIS, self.mesh,
                       divide=self.n_data)
        spmd.sum_grads([grads[k] for k in self.names if k not in self.stage_names],
                       STAGE_AXIS, self.mesh)
        from .loop import finish_update
        self.opt_state, _, self._nonfinite = finish_update(
            self.optimizer, cfg, self.opt_state, self._leaves(), grads, self._nonfinite,
            reduce=self._norm_reduce)
        for p in params.values():
            p.grad = None
        self._host_step += 1
        loss = loss.detach()
        if self.n_data > 1:
            dist.all_reduce(loss, group=self.mesh.group(DATA_AXIS))
            loss = loss / self.n_data
        return loss

    def train(self) -> Dict[str, Any]:
        """``num_train_epoch`` epochs of full batches (the host shuffle of
        ``np.random.default_rng(seed)``); a split smaller than one batch is
        refused."""
        from .checkpoint import wait_for_checkpoints
        cfg = self.cfg
        if self.opt_state is None:
            self.init_state()
        host_rng = np.random.default_rng(cfg.seed)
        n = len(self.train_data)
        if n < cfg.train_batch_size:
            raise ValueError(
                f'training split ({n} records) is smaller than one batch '
                f'({cfg.train_batch_size}); lower train_batch_size -- the '
                f'pipelined step needs full batches (B % n_micro == 0)')
        t0 = time.time()
        last_loss = float('nan')
        for _ in range(cfg.num_train_epoch):
            idx = np.arange(n)
            host_rng.shuffle(idx)
            stop = (n // cfg.train_batch_size) * cfg.train_batch_size
            for i in range(0, stop, cfg.train_batch_size):
                loss = self.train_step(self.train_data, idx[i:i + cfg.train_batch_size])
            last_loss = float(loss)
            self.epoch += 1
            if cfg.log_to_console:
                self.logger.info({'pp/loss': last_loss, 'step': self._host_step})
            if cfg.save_every_n_epoch and self.epoch % cfg.save_every_n_epoch == 0:
                self.save_checkpoint(tag=f'ep{self.epoch}')
        if cfg.save_final:
            self.save_checkpoint(tag='final')
        if cfg.async_checkpoint and self._is_writer():
            wait_for_checkpoints()
        dist.barrier()
        return {'loss': last_loss, 'steps': self._host_step, 'seconds': time.time() - t0}

    # ------------------------------------------------------------ checkpoints
    @staticmethod
    def _is_writer() -> bool:
        return dist.get_rank() == 0

    def save_checkpoint(self, tag: str = 'final') -> str:
        """The full train state as the one-device ``scan_blocks`` file
        (``ckpt-<tag>``): every rank gathers, rank 0 writes."""
        from .checkpoint import save_checkpoint
        path = os.path.join(os.path.abspath(self.output_dir), f'ckpt-{tag}')
        masks = [None] * self.n_data
        dist.all_gather_object(masks, self.rng.mask.get_state(),
                               group=self.mesh.group(DATA_AXIS))
        state = {'step': self._host_step, 'epoch': self.epoch,
                 'params': self.merged_params(),
                 'opt_state': {'count': self.opt_state.count,
                               'mu': self._full(self.opt_state.mu),
                               'nu': self._full(self.opt_state.nu)},
                 'rng': {'host': self.rng.host.get_state(),
                         'device': self.rng.device.get_state(), 'masks': masks}}
        if self._is_writer():
            os.makedirs(self.output_dir, exist_ok=True)
            save_checkpoint(path, state, async_save=self.cfg.async_checkpoint)
        dist.barrier()
        if self.cfg.log_to_console:
            self.logger.info(f'Checkpoint saved to {path}')
        return path

    def load_checkpoint(self, path: str) -> None:
        """Exact restore of a checkpoint of this model (from any mesh, or a
        one-device ``scan_blocks`` ``Trainer``): each rank keeps its part."""
        from .checkpoint import restore_checkpoint, wait_for_checkpoints
        if self.opt_state is None:
            self.init_state()
        if self._is_writer():
            wait_for_checkpoints()
        dist.barrier()
        raw = restore_checkpoint(path)
        self._load_full(raw['params'])
        self._reset_optimizer()
        opt = raw['opt_state']
        mu, nu = self._local(opt['mu']), self._local(opt['nu'])
        self.opt_state = dataclasses.replace(
            self.opt_state, count=int(opt['count']),
            mu={k: mu[k].to(self.device) for k in self.names},
            nu={k: nu[k].to(self.device) for k in self.names})
        rng = raw.get('rng', {})   # a checkpoint converted from JAX carries none
        if rng:
            self.rng.host.set_state(rng['host'])
            self.rng.device.set_state(rng['device'])
        masks = rng.get('masks')
        if masks and len(masks) == self.n_data:
            self.rng.mask.set_state(masks[self.mesh.index(DATA_AXIS)])
        self.epoch = int(raw.get('epoch', 0))
        self._host_step = int(raw.get('step', 0))
