"""The training and evaluation harness (the JAX package's ``Trainer``).

  * one train step: gather the minibatch rows from the device-resident
    split by index -> normalize + pad (+ TimeOut) -> forward with dropout ->
    BCE -> backward (microbatches collected for ``grad_accum``) -> global
    norm and the device-side non-finite counter -> the fused AdamW kernel,
    which also averages the microbatches and writes the bf16 compute copies
    the next forward reads (``loop.ComputeCopies``) -> the parameter EMA.
    No step waits for the device unless a metric is logged;
  * host shuffling with ``np.random.default_rng(cfg.seed)``, the same batch
    order as JAX, and the last partial batch dropped;
  * ``cfg.steps_per_dispatch`` K > 1 or ``cfg.epoch_scan``: K steps, or a
    whole epoch, per dispatch from a step tape -- on the GPU replays of a
    CUDA graph of the step (``train/dispatch.py``), bit-equal to the
    per-step loop; the per-step loop when the split is not resident;
  * eval epochs (per-sample losses, binary stats, macro-AUROC), early
    stopping on the eval loss with ``patience``, best and final checkpoints,
    resume from a checkpoint;
  * inference (``predict``, ``predict_long``), as the JAX ``eval_step``:
    z-normalize, ``time_end_pad``, forward, sigmoid, every batch padded to
    ``eval_batch_size`` (with copies of row 0) and trimmed, so the device
    always sees one batch shape; with ``enable_int8_inference`` evaluation
    and inference run on int8 Linear weights (``models/quantize.py``).

A split is resident on the device when it fits ``hbm_split_max_bytes``:
its signals in ``cfg.resident_dtype`` (f32, f16 or bf16), cast to f32 right
after each gather, its labels in f32.  A split whose signals are a tensor
(``synth_ptbxl_device``) moves with ``.to``, never through numpy.

Evaluation and inference serve the EMA weights when ``cfg.ema_decay > 0``.
Randomness: model init from a CPU generator seeded with ``cfg.seed``; dropout
seeds (attention kernel, hashed masks) from a host generator and Bernoulli
masks and TimeOut draws from a generator on the device, both seeded from
``cfg.seed`` and checkpointed.  ``cfg.linear_probe`` trains the head alone
(the optax chain, updates zeroed outside ``head``; train/pretrain.py).

``TrainerBase`` holds what the supervised trainer shares with the
pretrainers (train/pretrain.py, train/contrastive.py): device and
normalization stats, the optimizer and its state, the EMA, the generators,
seeded init, checkpoints and logging.

On a ('data', 'model') mesh (``parallel/``; ``mesh=``, or one built from
``cfg.mesh_data`` / ``cfg.mesh_model`` / ``cfg.fsdp``, or from the process
group when there is more than one rank) the trainers run one rank each:
the model placed by the partition rules (``parallel.mesh.ShardedModel``:
Megatron slices over 'model', DDP or FSDP2 over 'data'), every rank drawing
the same host shuffle and taking its rows of each (micro)batch, randomness
drawn as one device would draw it for the global batch
(``parallel.spmd``), the update tail on the local shards with the mesh-wide
norm, evaluation gathered over 'data' (metrics on the whole split), and
checkpoints gathered into the one-device file (rank 0 writes).  The resident
split is held whole on every rank, as JAX replicates it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import functools
import logging
import math
import os
import time
import weakref
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import TrainConfig, VitConfig
from ..models.vit import EcgVit
from ..ops.augment import timeout as timeout_op, timeout_draws
from ..ops.dropout import DropoutRng
from ..ops.normalize import normalize_fixed
from ..ops.pad import time_end_pad
from ..parallel import spmd
from ..runtime import default_device
from ..utils import tracing
from ..utils.logging import TbWriter, get_logger, pretty_log_dict
from .checkpoint import wait_for_checkpoints
from .loop import ComputeCopies, StepGrads, count_param_casts, finish_update, grad_accum
from .metrics import binary_stats, classification_report, multilabel_auroc, per_class_recall
from .optim import FusedAdamW, FusedAdamWState, make_optimizer


# TrainConfig.resident_dtype -> the storage dtype of a resident split's signals
RESIDENT_DTYPES = {None: torch.float32, 'float16': torch.float16,
                   'bfloat16': torch.bfloat16}


@dataclasses.dataclass
class SplitData:
    """One split: raw signals + multi-hot labels."""
    signals: np.ndarray   # (N, C, L) float32, unnormalized (raw 250 Hz grid);
                          # or a torch tensor (synth_ptbxl_device), on any device
    labels: np.ndarray    # (N, num_class) float32 multi-hot

    def __len__(self):
        return self.signals.shape[0]


def _prep_batch(sig: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                patch_size: int, train: bool = False,
                generator: Optional[torch.Generator] = None,
                timeout_scale=(0.0, 0.5), max_len: Optional[int] = None) -> torch.Tensor:
    """Per-batch transform: normalize -> pad -> crop to ``max_len`` (a record
    of the model's whole input length gains a zero patch from the always-pad
    quirk, which would exceed it) -> (``train``) TimeOut, drawn for the
    global batch on a mesh (``spmd.global_draw``)."""
    sig = normalize_fixed(sig, mean, std)
    sig = time_end_pad(sig, patch_size)[..., :max_len]
    if train:
        span, start = spmd.global_draw(sig.shape[0], lambda n: timeout_draws(
            (n,), *timeout_scale, generator=generator, device=sig.device))
        sig = timeout_op(sig, *timeout_scale, span_draw=span, start_draw=start)
    return sig


def eval_mode(fn):
    """Run ``fn`` under ``torch.inference_mode`` on one device and under
    ``torch.no_grad`` on a mesh: FSDP2 keeps the buffers it gathers into from
    one forward to the next, and inference tensors there would break the
    next training step."""
    @functools.wraps(fn)
    def run(self, *args, **kw):
        with torch.no_grad() if self.mesh is not None else torch.inference_mode():
            return fn(self, *args, **kw)
    return run


def _resolve_mesh(mesh, cfg: TrainConfig, device):
    """The trainer's mesh: ``mesh``; None for ``mesh=False`` (one device,
    even inside a process group); else one from ``cfg.mesh_data`` /
    ``cfg.mesh_model`` (``fsdp`` too) or, when the process group has more than
    one rank, every rank on 'data' (JAX's default mesh); else None (one
    device)."""
    import torch.distributed as dist
    if mesh is False:
        return None
    if mesh is not None:
        return mesh
    many = dist.is_initialized() and dist.get_world_size() > 1
    if not (many or cfg.mesh_data not in (None, 1) or cfg.mesh_model != 1 or cfg.fsdp):
        return None
    from ..parallel.mesh import make_mesh
    return make_mesh(cfg.mesh_data, cfg.mesh_model, device=device)


def _gather_states(gen: torch.Generator, mesh) -> list:
    """Every data rank's state of ``gen``, by data rank (a collective)."""
    import torch.distributed as dist
    out = [None] * mesh.shape['data']
    dist.all_gather_object(out, gen.get_state(), group=mesh.group('data'))
    return out


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal (at +-2 std) with
    variance 1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def flax_init_(model: torch.nn.Module, seed: Union[int, torch.Generator]) -> None:
    """Seeded init with flax's distributions: lecun-normal Linear weights,
    zero biases, unit LayerNorm scales, normal(0.02) tokens and position
    embeddings.  Drawn on the CPU in parameter order from one
    ``torch.Generator`` (``seed``, or one seeded with it), so the weights do
    not depend on the device.

    The fan-in depends on the kind of leaf: a Linear weight (out, in) has
    ``in``, and so does each layer of a ``scan_blocks`` stack (L, out, in),
    since ``nn.scan`` initialises its layers one by one; a MoE expert stack
    is one flax ``lecun_normal`` leaf in the JAX layout, whose leading
    expert axis counts in the fan-in: E * d for ``w1`` (E, d, f), E * f for
    ``w2`` (E, f, d).  The MoE router is a Linear; ``b1`` and ``b2`` are
    biases (zero).  The deepseek block's stacked experts (``gate_up``,
    ``down``) are initialised expert by expert, as Linear layers."""
    from ..models.port import flax_path
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            path = flax_path(name)
            if name.endswith(('cls_token', 'pos_embed', 'mask_token')):
                torch.nn.init.normal_(p, 0.0, 0.02, generator=gen)
            elif path[-1] in ('bias', 'b1', 'b2'):
                p.zero_()
            elif path[-1] in ('w1', 'w2'):
                _lecun_normal_(p, p.shape[0] * p.shape[1], gen)
            elif path[-1] in ('gate_up', 'down'):   # deepseek experts: one Linear each
                _lecun_normal_(p, p.shape[-1], gen)
            elif path[-1] == 'kernel':
                _lecun_normal_(p, p.shape[-1], gen)
            else:
                p.fill_(1.0)


class TrainerBase:
    """State and bookkeeping shared by the supervised trainer and the
    pretrainers: ``model`` on ``device``, the optimizer (fused AdamW or the
    optax chain) and its state, the EMA, the generators, the step and epoch
    counters, checkpoints and the log sinks."""

    def __init__(self, model: torch.nn.Module, model_cfg: VitConfig, train_cfg: TrainConfig,
                 train_data: Optional[SplitData], eval_data: Optional[SplitData],
                 norm_stats: Optional[Dict[str, Any]], output_dir: str, name: str,
                 logger_name: str, device=None, mesh=None):
        self.mesh = _resolve_mesh(mesh, train_cfg, device)
        self.device = self.mesh.device if self.mesh is not None else default_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.name = name
        self.model = model.eval()
        self.train_data, self.eval_data = train_data, eval_data
        stats = norm_stats or {'mean': [0.0] * model_cfg.num_channels,
                               'std': [1.0] * model_cfg.num_channels}
        self.mean = torch.tensor(stats['mean'], dtype=torch.float32, device=self.device)
        self.std = torch.tensor(stats['std'], dtype=torch.float32, device=self.device)
        self.output_dir = output_dir

        if train_cfg.train_batch_size % max(1, train_cfg.grad_accum):
            raise ValueError(f'grad_accum {train_cfg.grad_accum} must divide '
                             f'train_batch_size {train_cfg.train_batch_size}')
        n_data = 1 if self.mesh is None else self.mesh.shape['data']
        if (train_cfg.train_batch_size // max(1, train_cfg.grad_accum)) % n_data or \
                train_cfg.eval_batch_size % n_data:
            raise ValueError(f'the {n_data} data ranks must divide each microbatch '
                             f'({train_cfg.train_batch_size} / grad_accum '
                             f'{train_cfg.grad_accum}) and eval_batch_size '
                             f'{train_cfg.eval_batch_size}')
        n_train = len(train_data) if train_data is not None else 1
        self.steps_per_epoch = train_cfg.steps_per_epoch(n_train)
        self.total_steps = train_cfg.total_steps(n_train)
        self.optimizer, self.schedule = make_optimizer(train_cfg, self.total_steps)

        self.initialized = False
        self.opt_state: Optional[FusedAdamWState] = None
        self._copies: Optional[ComputeCopies] = None   # set with the optimizer state
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self.rng: Optional[DropoutRng] = None
        self.step = 0         # optimizer steps taken, on the host
        self.epoch = 0
        self._nonfinite = torch.zeros((), dtype=torch.int32, device=self.device)
        # id(SplitData) -> the split on the device, signals in the storage dtype
        self._resident: Dict[int, Any] = {}
        self._signal_dtype = RESIDENT_DTYPES[train_cfg.resident_dtype]
        self._int8: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.last_restore_info: Dict[str, Any] = {}
        self.logger = get_logger(logger_name)
        self.logger_fl = None
        self.tb = None
        self.sharded = None
        from ..models.moe import deepseek_layers
        self._routed = deepseek_layers(model)   # their bias update follows each step
        if self.mesh is not None:
            from ..parallel.mesh import shard_params
            from ..ops.adamw import NormReduce
            # the unsharded model's names, shapes and init order, without storage
            self._full_model = copy.deepcopy(model).to('meta')
            self.sharded = shard_params(self.model, self.mesh, train_cfg.fsdp)
            self._norm_reduce = NormReduce(self.sharded.norm_weights())
        count_param_casts(self.model)

    # ------------------------------------------------------------------ setup
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    def _leaves(self) -> Dict[str, torch.Tensor]:
        """Each parameter's storage on this rank (the tensor the update
        writes): the parameter itself on one device, its local shard on a
        mesh."""
        if self.sharded is not None:
            return self.sharded.leaves()
        return {k: p.detach() for k, p in self.params().items()}

    @property
    def _net(self) -> torch.nn.Module:
        """What a training forward calls: the model, or its DDP wrapper."""
        return self.model if self.sharded is None else self.sharded.net

    def _spmd(self):
        """The context of a step on this trainer's mesh (nothing without one)."""
        return spmd.mesh_context(self.mesh)

    def _local_take(self, take: np.ndarray, accum: int = 1) -> np.ndarray:
        """This rank's rows of a global batch of indices: of each of its
        ``accum`` microbatches, the slice of the rank's place on 'data' (JAX
        shards each microbatch over 'data')."""
        if self.mesh is None or self.mesh.shape['data'] == 1:
            return take
        from ..parallel.distributed import process_local_batch_slice
        chunks = take.reshape(accum, -1)
        return chunks[:, process_local_batch_slice(chunks.shape[1], self.mesh)].reshape(-1)

    def _full_state(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors laid out like the leaves as full (unsharded) tensors; on a
        mesh a collective of every rank."""
        if self.sharded is None:
            return dict(tensors)
        return self.sharded.full_state(tensors)

    def _is_writer(self) -> bool:
        import torch.distributed as dist
        return self.mesh is None or dist.get_rank() == 0

    def _commit_barrier(self) -> None:
        """On a mesh: rank 0's checkpoint in flight committed, then every
        rank past this point, so any rank may read it."""
        if self.mesh is not None:
            import torch.distributed as dist
            if self._is_writer():
                wait_for_checkpoints()
            dist.barrier()

    def _reset_run_state(self, seed: int) -> None:
        """Generators from ``seed``, step 0, fresh optimizer state and EMA.
        On a mesh with several data ranks, Bernoulli masks come from a
        generator seeded with (seed, data rank)."""
        host = torch.Generator().manual_seed(seed)
        dev = torch.Generator(device=self.device)
        dev.manual_seed(int(torch.randint(0, 1 << 62, (1,), generator=host)))
        mask = None
        if self.mesh is not None and self.mesh.shape['data'] > 1:
            mask = torch.Generator(device=self.device)
            mask.manual_seed(int(np.random.SeedSequence(
                [seed, self.mesh.index('data')]).generate_state(1, np.uint64)[0] >> 2))
        self.rng = DropoutRng(host=host, device=dev, mask=mask)
        self.step = 0
        self._reset_optimizer()

    def _reset_optimizer(self) -> None:
        params = self._leaves()
        self.opt_state = self.optimizer.init(params)
        self.ema = ({k: p.clone() for k, p in params.items()}
                    if self.cfg.ema_decay > 0 else None)
        self._copies = self._compute_copies()

    def _compute_copies(self) -> Optional[ComputeCopies]:
        """The compute copies of the cast leaves (``loop.ComputeCopies``),
        written from the parameters as they are now, where ``FusedAdamW``
        updates the leaves and no DDP or FSDP2 hook needs their f32
        gradients: on one device, and on a mesh of 'data' alone, whose tape
        steps average the gradients themselves; else None."""
        if (not isinstance(self.optimizer, FusedAdamW)
                or (self.sharded is not None and not self.sharded.flat_sync)):
            return None
        if self._copies is None:
            copies = ComputeCopies(self.model)
            return copies if copies.copies else None
        self._copies.write()
        return self._copies

    def _reading_copies(self) -> Optional[ComputeCopies]:
        """The compute copies a training step's forwards read: this
        trainer's, except on a mesh outside a tape step, where DDP syncs the
        f32 parameters' gradients."""
        if self.sharded is not None and not self.sharded.taped:
            return None
        return self._copies

    def init_state(self, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Seeded init (``flax_init_``); resets the optimizer state, the EMA,
        the step and the generators.  On a mesh every rank draws the
        unsharded init and keeps its shards."""
        seed = self.cfg.seed if seed is None else seed
        if self.sharded is not None:
            full = copy.deepcopy(self._full_model).to_empty(device='cpu')
            flax_init_(full, seed)
            self.sharded.load_full(dict(full.named_parameters()))
        else:
            self.model.to('cpu')
            flax_init_(self.model, seed)
            self.model.to(self.device)
        self._reset_run_state(seed)
        self.initialized = True
        self._info(f'initialized {self.model_cfg.meta} on {self.device}')
        return self.state_dict()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The parameters as the unsharded model's state_dict (on a mesh, a
        collective of every rank)."""
        if self.sharded is None:
            return self.model.state_dict()
        return self._full_state(self._leaves())

    def set_params(self, state_dict: Mapping[str, torch.Tensor]):
        """Install an externally built state_dict (e.g. flax params carried
        over with ``models.port.vit_state_dict_from_flax``, or a pretrained
        trunk from ``train.contrastive.load_any_encoder``), re-initializing
        the optimizer state and re-seeding the EMA from it."""
        if self.sharded is not None:
            from .checkpoint import check_params
            check_params(state_dict, self._full_model.state_dict(), 'state_dict')
            self.sharded.load_full(state_dict)
        else:
            self.model.load_state_dict(state_dict, strict=True)
            self.model.to(self.device)
        if self.rng is None:
            self._reset_run_state(self.cfg.seed)
        else:
            self._reset_optimizer()
        self.initialized = True
        self._refresh_int8()
        self._info(f'loaded weights into {self.model_cfg.meta} on {self.device}')
        return self.state_dict()

    def _objective(self, loss: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        """What a step minimises: the task ``loss``, plus ``moe_aux_weight``
        times the MoE aux loss ``aux`` for a MoE model (metrics keep the task
        loss, as in JAX)."""
        cfg = self.model_cfg
        if cfg.moe_num_experts > 0:
            weight = cfg.moe_seq_aux_weight if cfg.block != 'vit' else cfg.moe_aux_weight
            return loss + weight * aux
        return loss

    def _info(self, msg: str) -> None:
        if self.cfg.log_to_console:
            self.logger.info(msg)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the device, copied without waiting for it."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _resident_split(self, data: SplitData, build):
        """``build(data)``, the split's device tensors, made once per split
        and dropped with it."""
        key = id(data)
        if key not in self._resident:
            self._resident[key] = build(data)
            # evict with the SplitData: a reused id() must not alias a new split
            weakref.finalize(data, self._resident.pop, key, None)
        return self._resident[key]

    def _on_device(self, x, dtype: torch.dtype) -> torch.Tensor:
        """``x`` (a host array, or a tensor on any device) on the trainer's
        device in ``dtype``.  A tensor moves with ``.to``, never through
        numpy; a host array is cast before its copy."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dtype).to(self.device)

    def _rows(self, x, take: np.ndarray) -> torch.Tensor:
        """Rows ``take`` of ``x`` in f32 on the device: the copied batch of a
        split that is not resident."""
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(take, device=x.device)].to(self.device, torch.float32)
        return self._to_device(np.asarray(x[take], np.float32))

    def _update(self, grads: StepGrads, scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The update tail of a step (``loop.finish_update``) on its
        ``grads`` (``loop.grad_accum``'s), the compute copies written with
        the parameters; returns the gradient norm.  The parameters go in as
        they are: every in-place write of the tail runs under ``no_grad`` or
        in the kernels.  ``scalars``: a step tape's [lr, bc1, bc2, -lr] on
        the device."""
        with tracing.span('step.update'):
            self.opt_state, grad_norm, self._nonfinite = finish_update(
                self.optimizer, self.cfg, self.opt_state, self._leaves(), grads,
                self._nonfinite, self.ema,
                reduce=None if self.sharded is None else self._norm_reduce, scalars=scalars,
                copies=self._copies)
            for p in self.params().values():
                p.grad = None
            for layer in self._routed:
                layer.update_bias(self.model_cfg.moe_bias_rate)
        self.step += 1
        return grad_norm

    def _check_finite(self, where: str) -> None:
        if self.cfg.debug_nans and int(self._nonfinite) > 0:
            # the reference's grad-clip error_if_nonfinite (train.py:281): the
            # device counter catches every step, raised at this host sync
            raise FloatingPointError(
                f'non-finite gradient norm {where} ({int(self._nonfinite)} bad '
                f'steps; params unpoisoned)')

    def _served_state(self) -> Dict[str, torch.Tensor]:
        """The weights evaluation and inference serve: the EMA when
        ``cfg.ema_decay > 0``, else the trained parameters."""
        if self.ema is not None:
            return self.ema
        return self._leaves()

    def served_model(self) -> torch.nn.Module:
        """A copy of the model holding the served weights
        (``_served_state``), in eval mode (``cli visualize`` and
        ``models.export_artifact`` read it); on a mesh the unsharded model on
        this rank's device (a collective of every rank)."""
        if self.sharded is not None:
            full = self._full_state(self._served_state())
            model = copy.deepcopy(self._full_model).to_empty(device=self.device).eval()
            with torch.no_grad():
                for key, val in full.items():
                    model.get_parameter(key).copy_(val)
            return model
        model = copy.deepcopy(self.model).eval()
        with torch.no_grad():
            for key, val in self._served_state().items():
                model.get_parameter(key).copy_(val)
        return model

    @contextlib.contextmanager
    def _ema_swapped(self):
        """On a mesh: the EMA shards written into the parameters' storage
        for the duration (FSDP2 gathers the storage itself, so the weights
        cannot be handed over as ``functional_call`` does), then restored."""
        leaves = self._leaves()
        saved = {k: v.clone() for k, v in leaves.items()}
        try:
            with torch.no_grad():
                for k, v in leaves.items():
                    v.copy_(self.ema[k])
            yield
        finally:
            with torch.no_grad():
                for k, v in leaves.items():
                    v.copy_(saved[k])

    def _eval_forward(self, *args, **kw):
        """The eval-mode forward on the served weights (``_served_state``),
        or on their int8 snapshot while int8 inference is enabled."""
        self.model.eval()
        if self._int8 is not None:
            from ..models.quantize import int8_weights
            q = self._int8
            model = q.get('model', self.model)
            with spmd.mesh_context(q.get('mesh')), int8_weights(model, q['qweights'],
                                                                q['scales']):
                return torch.func.functional_call(model, q['rest'], args, kw)
        if self.sharded is not None:
            with self._spmd(), torch.no_grad():
                try:
                    if self.ema is None:
                        return self.model(*args, **kw)
                    with self._ema_swapped():
                        return self.model(*args, **kw)
                finally:
                    self.sharded.reshard()
        if self.ema is not None:
            return torch.func.functional_call(self.model, self.ema, args, kw)
        return self.model(*args, **kw)

    def _refresh_int8(self) -> None:
        """Re-quantize the int8 snapshot after a weight swap (``set_params``,
        ``load_checkpoint``), so int8 inference never serves stale weights."""
        if self._int8 is not None:
            self.enable_int8_inference()

    # ------------------------------------------------------------ checkpoints
    def latest_checkpoint(self) -> Optional[str]:
        """Most recent committed ``ckpt-*`` under output_dir."""
        from .checkpoint import latest_committed_checkpoint
        self._commit_barrier()
        return latest_committed_checkpoint(self.output_dir)

    def save_checkpoint(self, tag: str = 'final') -> str:
        """Save the full train state as ``ckpt-<tag>`` under output_dir; with
        ``cfg.async_checkpoint`` the write finishes on the writer thread."""
        from .checkpoint import save_checkpoint
        path = os.path.join(os.path.abspath(self.output_dir), f'ckpt-{tag}')
        state = {'step': self.step, 'epoch': self.epoch,
                 'params': self.state_dict(),
                 'opt_state': {'count': self.opt_state.count,
                               'mu': self._full_state(self.opt_state.mu),
                               'nu': self._full_state(self.opt_state.nu)},
                 'rng': {'host': self.rng.host.get_state(),
                         'device': self.rng.device.get_state()}}
        if self.ema is not None:
            state['ema_params'] = self._full_state(self.ema)
        if self.rng.mask is not None:   # every data rank's mask generator
            state['rng']['masks'] = _gather_states(self.rng.mask, self.mesh)
        if self._is_writer():
            save_checkpoint(path, state, async_save=self.cfg.async_checkpoint)
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()
        self._info(f'Checkpoint saved to {path}'
                   + (' (async)' if self.cfg.async_checkpoint else ''))
        return path

    def load_checkpoint(self, path: str):
        """Restore a checkpoint of this model: params, step, epoch, the
        generators (kept as they are when the checkpoint has none, as one
        converted from the JAX package), and -- when they match this
        trainer -- the optimizer state (else it is re-initialized, with a
        warning) and the EMA (seeded from the params when the checkpoint has
        none; dropped, and ``last_restore_info['dropped_ema']`` set, when
        this trainer keeps none)."""
        from .checkpoint import restore_checkpoint
        log = logging.getLogger(__name__)
        if not self.initialized:
            self.init_state()
        self._commit_barrier()
        raw = restore_checkpoint(path)
        if self.sharded is not None:
            from .checkpoint import check_params
            full_shapes = self._full_model.state_dict()
            try:
                check_params(raw['params'], full_shapes, f'checkpoint {path} params')
            except ValueError as e:
                raise ValueError(f'checkpoint {path} params do not match this model '
                                 f'(wrong model size/config?): {e}') from None
            self.sharded.load_full(raw['params'])
            mine = self.sharded.local
        else:
            try:
                self.model.load_state_dict(raw['params'], strict=True)
            except RuntimeError as e:
                raise ValueError(f'checkpoint {path} params do not match this model '
                                 f'(wrong model size/config?): {e}') from None
            self.model.to(self.device)
            full_shapes = None
            mine = dict
        params = self._leaves()
        self._reset_optimizer()
        opt = raw['opt_state']
        fresh = self.opt_state
        want = {k: (full_shapes[k].shape if full_shapes is not None
                    else getattr(fresh, 'mu')[k].shape) for k in params}
        if all(k in opt[m] and opt[m][k].shape == want[k]
               and opt[m][k].dtype == getattr(fresh, m)[k].dtype
               for m in ('mu', 'nu') for k in params):
            mu, nu = mine(opt['mu']), mine(opt['nu'])
            self.opt_state = FusedAdamWState(
                count=int(opt['count']),
                mu={k: mu[k].to(self.device) for k in params},
                nu={k: nu[k].to(self.device) for k in params})
        else:
            log.warning('optimizer state in %s does not match this trainer (e.g. '
                        'another adam_mu_dtype); reinitialized it', path)
        extra: Dict[str, Any] = {'epoch': int(raw['epoch'])}
        if self.ema is not None:
            if 'ema_params' not in raw:
                log.warning('checkpoint %s has no EMA; seeding it from the params', path)
            ema = mine(raw.get('ema_params', raw['params']))
            self.ema = {k: ema[k].to(self.device).clone() for k in params}
        elif 'ema_params' in raw:
            log.warning('checkpoint %s carries EMA params this trainer does not '
                        'track (ema_decay=0); dropping them', path)
            extra['dropped_ema'] = True
        rng = raw.get('rng', {})   # a checkpoint converted from JAX carries none
        if rng:
            self.rng.host.set_state(rng['host'])
            self.rng.device.set_state(rng['device'])
        masks = rng.get('masks')
        if self.rng.mask is not None and masks and len(masks) == self.mesh.shape['data']:
            self.rng.mask.set_state(masks[self.mesh.index('data')])
        self.step = int(raw['step'])
        self.epoch = int(raw['epoch'])
        self.last_restore_info = extra
        self._refresh_int8()
        return self.state_dict()

    # ----------------------------------------------------------------- logging
    def _open_sinks(self, logger_name: str, file_name: str) -> None:
        """The file log ``output_dir/file_name`` and TensorBoard ``output_dir/tb``."""
        if not self._is_writer():   # on a mesh, rank 0 keeps the files
            self.logger_fl, self.tb = None, TbWriter(None)
            return
        self.logger_fl = get_logger(logger_name,
                                    file_path=os.path.join(self.output_dir, file_name))
        self.tb = TbWriter(os.path.join(self.output_dir, 'tb'))

    def _log(self, payload: Dict[str, Any]):
        pretty = pretty_log_dict(payload)
        if self.cfg.log_to_console:
            self.logger.info(str(pretty))
        if self.logger_fl:
            self.logger_fl.info(str(pretty))
        if self.tb:
            self.tb.log(payload, step=self.step)


class Trainer(TrainerBase):
    """Supervised multi-label trainer (the reference MyTrainer equivalent)."""

    def __init__(self, model_cfg: VitConfig, train_cfg: TrainConfig,
                 train_data: Optional[SplitData] = None,
                 eval_data: Optional[SplitData] = None,
                 norm_stats: Optional[Dict[str, Any]] = None,
                 output_dir: Optional[str] = None, name: str = 'EcgVit', device=None,
                 mesh=None):
        self.save_time = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
        # the deepseek and afmoe blocks are built on the device (a CPU build of
        # ~1e9 parameters would take longer than the step); weights come after
        with torch.device(default_device(device) if model_cfg.block != 'vit' else 'cpu'):
            model = EcgVit(model_cfg)
        super().__init__(model, model_cfg, train_cfg, train_data, eval_data,
                         norm_stats, output_dir or os.path.join('runs', self.save_time),
                         name, f'{name} Train', device, mesh)
        if train_cfg.linear_probe:
            # the head alone: the optax chain with the trunk's updates zeroed
            from .pretrain import make_probe_optimizer
            self.optimizer, self.schedule = make_probe_optimizer(
                train_cfg, self.total_steps, self.params())
        # on the device once: a step then makes no host copy of it
        self._loss_weight = (None if train_cfg.loss_weight is None else torch.tensor(
            train_cfg.loss_weight, dtype=torch.float32, device=self.device))
        self.dispatcher = None   # train()'s train/dispatch.Dispatcher, when it has one
        self.dispatch_info: Optional[Dict[str, Any]] = None   # its info() after train()

    # ------------------------------------------------------------------ steps
    def _split_arrays(self, data: SplitData):
        """The split on the device (signals in ``cfg.resident_dtype``, labels
        in f32) when it fits ``hbm_split_max_bytes`` (or ``device_resident``
        says so), so a step gathers its rows on the device from an index
        vector; else None (each batch is copied)."""
        cfg = self.cfg
        resident = (cfg.device_resident if cfg.device_resident is not None
                    else data.signals.nbytes + data.labels.nbytes <= cfg.hbm_split_max_bytes)
        if not resident:
            return None
        return self._resident_split(data, lambda d: (
            self._on_device(d.signals, self._signal_dtype),
            self._on_device(d.labels, torch.float32)))

    def _step_inputs(self, data: SplitData, take: np.ndarray):
        """(signals, labels, idx) on the device: the whole resident split and
        the real indices, or the copied batch and 0..n-1.  The signals come
        in their storage dtype; the caller casts the gathered rows to f32."""
        dev = self._split_arrays(data)
        if dev is not None:
            sigs, labs = dev
            return sigs, labs, self._to_device(take.astype(np.int64))
        return (self._rows(data.signals, take), self._rows(data.labels, take),
                torch.arange(take.size, device=self.device))

    def train_step(self, data: SplitData, take: np.ndarray) -> Dict[str, Any]:
        """One optimizer step on the rows ``take`` of ``data``.  Returns the
        metrics (0-d device tensors, and the learning rate as a float)."""
        if not self.initialized:
            raise RuntimeError('call init_state() or set_params() first')
        accum = max(1, self.cfg.grad_accum)
        tracing.collect(wait=False)
        marks = tracing.step_marks(self.device)
        sigs, labs, idx = self._step_inputs(data, self._local_take(take, accum))
        lr = self.optimizer.lr_at(self.step)
        m = self._step(sigs, labs, idx, marks=marks)
        marks.mark('tail')
        marks.launched()
        return {'loss': m.pop('loss'), 'learning_rate': lr, **m}

    def _tape_step(self, sigs: torch.Tensor, labs: torch.Tensor, idx: torch.Tensor,
                   seeds: torch.Tensor, scalars: torch.Tensor,
                   marks=tracing.NO_MARKS) -> Dict[str, torch.Tensor]:
        """One step of a step tape (``train/dispatch.py``): the rows ``idx``
        of the resident split, the dropout seeds ``seeds`` and the optimizer
        scalars ``scalars`` [lr, bc1, bc2, -lr], all on the device, so the
        step reads no host value and a CUDA graph can capture it.  Returns
        the metrics as 0-d device tensors (no learning rate)."""
        taped = contextlib.nullcontext() if self.sharded is None else self.sharded.taped_step()
        with self.rng.taped(seeds), taped:
            return self._step(sigs, labs, idx, scalars, marks)

    def _step(self, sigs: torch.Tensor, labs: torch.Tensor, idx: torch.Tensor,
              scalars: Optional[torch.Tensor] = None,
              marks=tracing.NO_MARKS) -> Dict[str, torch.Tensor]:
        """Forward, backward and update on rows ``idx`` of ``sigs``/``labs``;
        the loss, gradient norm and binary stats as 0-d device tensors.
        ``marks`` (``utils.tracing.StepMarks``): the step's start and the ends
        of its forward, backward and update; the caller marks the end of
        the tail, once the metrics are where it keeps them."""
        cfg = self.cfg
        accum = max(1, cfg.grad_accum)
        params = self.params()
        self.model.train()
        marks.start()

        def micro(idx_k):
            sig = sigs.index_select(0, idx_k).float()
            lab = labs.index_select(0, idx_k)
            sig = _prep_batch(sig, self.mean, self.std, self.model_cfg.patch_size,
                              train=cfg.augment_timeout, generator=self.rng.device,
                              max_len=self.model_cfg.max_signal_length)
            out = self._net(sig, labels=lab, loss_weight=self._loss_weight, rng=self.rng)
            # metrics of the global (micro)batch; identities on one device
            return ((spmd.mean_over_data(out.loss.detach()),
                     spmd.gather_rows(out.logits.detach()), spmd.gather_rows(lab)),
                    self._objective(out.loss, out.aux_loss))

        with self._spmd(), tracing.regions(marks):
            aux, grads = grad_accum(micro, params, idx, accum, self.sharded, marks,
                                    self._reading_copies())
        self.model.eval()
        grad_norm = self._update(grads, scalars)
        marks.mark('update')
        loss = torch.stack([a[0] for a in aux]).mean()
        logits = torch.cat([a[1] for a in aux])
        lab = torch.cat([a[2] for a in aux])
        probs = torch.sigmoid(logits.float())
        return {'loss': loss, 'grad_norm': grad_norm, **binary_stats(probs, lab)}

    # ------------------------------------------------------------------ loops
    def _index_batches(self, data: SplitData, batch_size: int, shuffle_rng=None,
                       drop_last: bool = True) -> Iterator[Tuple[np.ndarray, int]]:
        n = len(data)
        idx = np.arange(n)
        if shuffle_rng is not None:
            shuffle_rng.shuffle(idx)
        stop = (n // batch_size) * batch_size if drop_last else n
        for i in range(0, max(stop, 0), batch_size):
            take = idx[i:i + batch_size]
            n_real = take.size
            if n_real < batch_size:  # pad the final batch; trimmed on the host
                take = np.concatenate([take, np.zeros(batch_size - n_real, np.int64)])
            yield take, n_real

    def train(self, resume: Union[bool, str] = False) -> Dict[str, Any]:
        """Run the training loop.  ``resume``: True restarts from the latest
        checkpoint in output_dir if there is one; a string restores that
        checkpoint."""
        cfg = self.cfg
        os.makedirs(self.output_dir, exist_ok=True)
        if resume:
            path = resume if isinstance(resume, str) else self.latest_checkpoint()
            if path:
                self.load_checkpoint(path)
                self._info(f'Resumed from {path} (epoch {self.epoch})')
        self._open_sinks(f'{self.name} TrainFile', 'train.log')
        if not self.initialized:
            self.init_state()
        self._info(f'Launched training {self.model_cfg.meta} with {dataclasses.asdict(cfg)}')

        host_rng = np.random.default_rng(cfg.seed)
        best_eval_loss, n_bad_ep = float('inf'), 0
        t_start = time.time()
        history = []
        self._nonfinite.zero_()
        if cfg.do_eval and self.eval_data is not None:
            self._log_epoch(self.evaluate(self.eval_data), prefix='eval')
        self.dispatcher = self._dispatcher()
        for _ in range(self.epoch, cfg.num_train_epoch):
            self.epoch += 1
            if self.dispatcher is not None and self.dispatcher.scan:
                self._train_epoch_scanned(host_rng)
            elif self.dispatcher is not None:
                self._train_epoch_chunked(host_rng)
            else:
                for take, _ in self._index_batches(self.train_data, cfg.train_batch_size,
                                                   shuffle_rng=host_rng):
                    metrics = self.train_step(self.train_data, take)
                    if (not cfg.log_per_epoch) or self.step % self.steps_per_epoch == 0:
                        with tracing.span('train.read', self.step):
                            payload = {f'train/{k}': float(v) for k, v in metrics.items()}
                        payload.update(epoch=self.epoch, step=self.step)
                        self._check_finite(f'by step {self.step}')
                        self._log(payload)
            self._check_finite(f'during epoch {self.epoch}')
            if cfg.save_every_n_epoch and self.epoch % cfg.save_every_n_epoch == 0:
                self.save_checkpoint(tag=f'ep{self.epoch}')
            if cfg.do_eval and self.eval_data is not None:
                eval_metrics = self.evaluate(self.eval_data)
                self._log_epoch(eval_metrics, prefix='eval')
                history.append(eval_metrics)
                if eval_metrics['loss'] < best_eval_loss:
                    best_eval_loss, n_bad_ep = eval_metrics['loss'], 0
                    self.save_checkpoint(tag='best')
                else:
                    n_bad_ep += 1
                if n_bad_ep >= cfg.patience:
                    self._info(f'Training terminated early at epoch {self.epoch} '
                               f'(patience {cfg.patience}, best eval loss '
                               f'{best_eval_loss:.4f})')
                    break
        self.dispatch_info = None if self.dispatcher is None else self.dispatcher.info()
        self.dispatcher = None   # the graphs and their pool go with it
        if cfg.save_final:
            self.save_checkpoint(tag='final')
        wait_for_checkpoints()   # every save committed before train() returns
        dt = time.time() - t_start
        self._info(f'Training completed in {dt:.1f}s')
        self.tb.close()
        return {'best_eval_loss': best_eval_loss, 'history': history,
                'epochs': self.epoch, 'seconds': dt}

    def _dispatcher(self):
        """The ``Dispatcher`` of ``cfg.epoch_scan`` (which wins) or of
        ``cfg.steps_per_dispatch`` > 1 for this ``train()``; None for the
        per-step loop, which both fall back to when the train split is not
        device-resident or is smaller than one batch (the JAX rule and info
        line)."""
        from .dispatch import Dispatcher
        cfg = self.cfg
        if not (cfg.epoch_scan or cfg.steps_per_dispatch > 1):
            return None
        if (self._split_arrays(self.train_data) is None
                or self.steps_per_epoch * cfg.train_batch_size > len(self.train_data)):
            self._info('epoch_scan/steps_per_dispatch requested but the train split is not '
                       'device-resident (or smaller than one batch); falling back to the '
                       'per-step loop')
            return None
        if self.sharded is not None and not self.sharded.flat_sync:
            self._info('epoch_scan/steps_per_dispatch on a mesh with a model axis or FSDP: '
                       'each dispatch runs its steps eagerly through the step tape (Megatron '
                       'slices and FSDP2 are not captured in a CUDA graph)')
        if cfg.epoch_scan:
            return Dispatcher(self, self.steps_per_epoch, scan=True)
        return Dispatcher(self, cfg.steps_per_dispatch, scan=False)

    def _train_epoch_scanned(self, host_rng) -> None:
        """One epoch as one dispatch (``cfg.epoch_scan``): the host shuffle
        drawn as the per-step loop draws it, the epoch's tape uploaded once,
        the steps run back to back; the per-step losses and gradient norms
        fetched once at the end and written to TensorBoard per step, and one
        epoch payload (the JAX keys) to the console and the file log."""
        cfg = self.cfg
        steps, bsz = self.steps_per_epoch, cfg.train_batch_size
        idx = np.arange(len(self.train_data))
        host_rng.shuffle(idx)    # the draw of _index_batches: the same batches
        losses, gnorms, _ = self.dispatcher.run(idx[:steps * bsz].reshape(steps, bsz))
        with tracing.span('train.read', self.step):
            losses, gnorms = torch.stack([losses, gnorms]).cpu().numpy()   # one fetch
        self._check_finite(f'during epoch {self.epoch}')
        if self.tb:   # the per-step curve, recorded at epoch end
            first = self.step - steps + 1
            for i, (loss, gnorm) in enumerate(zip(losses, gnorms)):
                self.tb.log({'train/loss': float(loss), 'train/grad_norm': float(gnorm)},
                            step=first + i)
        payload = {'train/loss': float(losses[-1]),
                   'train/loss_epoch_mean': float(losses.mean()),
                   'train/grad_norm': float(gnorms[-1]),
                   'train/learning_rate': float(self.schedule(self.step - 1)),
                   'epoch': self.epoch, 'step': self.step}
        pretty = pretty_log_dict(payload)
        if cfg.log_to_console:
            self.logger.info(str(pretty))
        if self.logger_fl:
            self.logger_fl.info(str(pretty))

    def _train_epoch_chunked(self, host_rng) -> None:
        """One epoch K steps a dispatch (``cfg.steps_per_dispatch``): the
        host shuffle drawn as the per-step loop draws it, steps_per_epoch //
        K dispatches, then the leftover steps one a dispatch (on the GPU a
        one-step graph in the K-step graph's memory pool).  One
        payload per dispatch (the last step's metrics, at the host step) and
        per leftover step, or with ``cfg.log_per_epoch`` one per epoch with
        ``train/loss_epoch_mean`` (over the dispatched steps, as in JAX)."""
        cfg = self.cfg
        k, bsz = cfg.steps_per_dispatch, cfg.train_batch_size
        idx = np.arange(len(self.train_data))
        host_rng.shuffle(idx)    # the draw of _index_batches: the same batches
        n_chunks, leftover = divmod(self.steps_per_epoch, k)
        ep_losses = []
        for c in range(n_chunks):
            losses, _, metrics = self.dispatcher.run(
                idx[c * k * bsz:(c + 1) * k * bsz].reshape(k, bsz))
            ep_losses.append(losses)
            if not cfg.log_per_epoch:
                with tracing.span('train.read', self.step):
                    payload = {f'train/{key}': float(v) for key, v in metrics.items()}
                payload.update(epoch=self.epoch, step=self.step)
                self._check_finite(f'by step {self.step}')
                self._log(payload)
        pos = n_chunks * k * bsz
        for i in range(leftover):
            _, _, metrics = self.dispatcher.run(idx[pos + i * bsz:pos + (i + 1) * bsz][None])
            if not cfg.log_per_epoch:
                with tracing.span('train.read', self.step):
                    payload = {f'train/{key}': float(v) for key, v in metrics.items()}
                payload.update(epoch=self.epoch, step=self.step)
                self._log(payload)
        if cfg.log_per_epoch:
            with tracing.span('train.read', self.step):
                losses = torch.cat(ep_losses).cpu().numpy() if ep_losses else np.zeros(0)
            self._check_finite(f'during epoch {self.epoch}')
            payload = {'train/loss': float(metrics['loss']),
                       'train/grad_norm': float(metrics['grad_norm']),
                       'train/learning_rate': float(self.schedule(self.step - 1)),
                       'epoch': self.epoch, 'step': self.step}
            if losses.size:
                payload['train/loss_epoch_mean'] = float(losses.mean())
            self._log(payload)

    # -------------------------------------------------------------- inference
    @eval_mode
    def evaluate(self, data: SplitData, loss_reduction: str = 'mean',
                 return_predictions: bool = False) -> Dict[str, Any]:
        """Eval pass (reference train.py:321-378): per-sample losses, sigmoid
        probabilities, binary stats, macro and per-class AUROC."""
        if not self.initialized:
            raise RuntimeError('call init_state() or load a checkpoint first')
        if len(data) == 0:
            raise ValueError('evaluate() called on an empty split (e.g. a tiny corpus '
                             'whose strat_fold draw left fold 9/10 empty)')
        losses, probs_all, labels_all = [], [], []
        for take, n_real in self._index_batches(data, self.cfg.eval_batch_size,
                                                drop_last=False):
            sigs, labs, idx = self._step_inputs(data, self._local_take(take))
            sig = _prep_batch(sigs.index_select(0, idx).float(), self.mean, self.std,
                              self.model_cfg.patch_size,
                              max_len=self.model_cfg.max_signal_length)
            out = self._eval_forward(sig, labels=labs.index_select(0, idx),
                                     loss_reduction='none')
            with self._spmd():   # the data ranks' rows, in batch order
                loss, logits = spmd.gather_rows(out.loss), spmd.gather_rows(out.logits)
            losses.append(loss[:n_real].cpu().numpy())
            probs_all.append(torch.sigmoid(logits.float())[:n_real].cpu().numpy())
            labels_all.append(data.labels[take[:n_real]])
        losses = np.concatenate(losses)
        probs_np = np.concatenate(probs_all)
        labels_np = np.concatenate(labels_all)
        out: Dict[str, Any] = {
            'loss': float(losses.mean()),
            **{k: float(v) for k, v in binary_stats(torch.from_numpy(probs_np),
                                                    torch.from_numpy(labels_np)).items()},
            **multilabel_auroc(probs_np, labels_np),
            'per_class_recall': per_class_recall(probs_np, labels_np),
            'classification_report': classification_report(probs_np, labels_np),
        }
        if loss_reduction == 'none':
            out['per_sample_loss'] = losses
        if return_predictions:
            out['predictions'] = {'probs': probs_np, 'labels': labels_np}
        return out

    def enable_int8_inference(self) -> Dict[str, float]:
        """Quantize the served weights (the EMA when tracked) to int8 with
        per-output-channel scales (``models/quantize.py``); ``evaluate``,
        ``predict`` and ``predict_long`` then run on them.  The other leaves
        are snapshotted with them.  Returns the size summary.  Call again
        after further training to re-snapshot.

        On a mesh (a collective of every rank), as JAX replicates the int8
        tree: the full served state is gathered (``ShardedModel.full_state``),
        quantized, and served replicated -- one unsharded model per rank,
        without Megatron slices, DDP or FSDP2, run under the mesh's 'data'
        axis alone (``parallel.mesh.DataAxis``), so each data rank computes
        its rows of a batch and the rows are gathered once per data rank.
        ``disable_int8_inference`` returns to the sharded model."""
        from ..models.quantize import quantize_int8, quantized_bytes
        if not self.initialized:
            raise RuntimeError('call init_state() or load a checkpoint first')
        served = self._full_state(self._served_state())
        if self.sharded is not None:
            served = {k: v.to(self.device) for k, v in served.items()}
        qweights, scales = quantize_int8(served)
        rest = {k: v.detach().clone() for k, v in served.items() if k not in qweights}
        self._int8 = {'qweights': qweights, 'scales': scales, 'rest': rest}
        if self.sharded is not None:
            self._int8.update(model=self._replicated_model(qweights),
                              mesh=self.mesh.data_axis())
        before = quantized_bytes(served.values())
        after = quantized_bytes([*qweights.values(), *scales.values(), *rest.values()])
        summary = {'param_bytes_f32': before, 'param_bytes_int8': after,
                   'compression': before / max(after, 1)}
        self._info(f'int8 inference enabled: {summary}')
        return summary

    def disable_int8_inference(self) -> None:
        self._int8 = None

    def _replicated_model(self, qweights: Mapping[str, torch.Tensor]) -> torch.nn.Module:
        """The unsharded model on this rank's device in eval mode, holding no
        storage for the leaves in ``qweights`` (int8 inference computes with
        those, and ``_eval_forward`` hands it the rest)."""
        model = copy.deepcopy(self._full_model)
        for key in qweights:
            owner, _, leaf = key.rpartition('.')
            model.get_submodule(owner).register_parameter(
                leaf, torch.nn.Parameter(torch.empty(0, device='meta'), requires_grad=False))
        return model.to_empty(device=self.device).eval()

    @eval_mode
    def predict(self, signals: np.ndarray) -> np.ndarray:
        """Batch inference: per-record sigmoid probabilities (N, num_class)."""
        if not self.initialized:
            raise RuntimeError('call init_state() or set_params() first')
        data = SplitData(
            signals=np.asarray(signals, np.float32),
            labels=np.zeros((len(signals), self.model_cfg.num_class), np.float32))
        probs_all = []
        for take, n_real in self._index_batches(data, self.cfg.eval_batch_size,
                                                drop_last=False):
            sig = torch.from_numpy(data.signals[self._local_take(take)]).to(self.device)
            sig = _prep_batch(sig, self.mean, self.std, self.model_cfg.patch_size,
                              max_len=self.model_cfg.max_signal_length)
            logits = self._eval_forward(sig).logits
            with self._spmd():
                probs = torch.sigmoid(spmd.gather_rows(logits).float())
            probs_all.append(probs[:n_real].cpu().numpy())
        return np.concatenate(probs_all)

    def predict_long(self, signals: np.ndarray, window: Optional[int] = None,
                     hop: Optional[int] = None, agg: str = 'max') -> np.ndarray:
        """Sliding-window inference on records longer than the model's input:
        window the signal, predict every window as one batch, aggregate the
        per-class probabilities ('max' or 'mean') across windows.

        ``window`` defaults to the model's input length minus one patch (the
        always-pad quirk), ``hop`` to window/2.  Shorter records go straight
        to :meth:`predict`.  Returns (N, num_class).
        """
        if agg not in ('max', 'mean'):
            raise ValueError(f"agg must be 'max' or 'mean', got {agg!r}")
        signals = np.asarray(signals, np.float32)
        if signals.ndim == 2:
            signals = signals[None]
        n, c, length = signals.shape
        explicit_window = window is not None
        window = window or (self.model_cfg.max_signal_length
                            - self.model_cfg.patch_size)
        hop = hop or max(1, window // 2)
        # predict() is lossless for any L < max_signal_length: time_end_pad
        # takes L to the next patch multiple, which stays <= max only while
        # L < max.  Only slide windows beyond that, or when asked to.
        direct = (length <= window if explicit_window
                  else length < self.model_cfg.max_signal_length)
        if direct:
            return self.predict(signals)
        starts = list(range(0, length - window + 1, hop))
        if starts[-1] + window < length:       # cover the tail remainder
            starts.append(length - window)
        windows = np.stack([signals[:, :, s:s + window] for s in starts],
                           axis=1)             # (N, W, C, window)
        flat = windows.reshape(n * len(starts), c, window)
        probs = self.predict(flat).reshape(n, len(starts), -1)
        return probs.max(axis=1) if agg == 'max' else probs.mean(axis=1)

    # ----------------------------------------------------------------- logging
    def _log_epoch(self, metrics: Dict[str, Any], prefix: str):
        payload = {f'{prefix}/{k}': v for k, v in metrics.items()
                   if k not in ('per_sample_loss', 'predictions', 'history',
                                'classification_report')}
        payload.update(epoch=self.epoch, step=self.step)
        self._log(payload)


def get_all_setup(model_size: str = 'small', train_args: Optional[Dict] = None,
                  train_data: Optional[SplitData] = None,
                  eval_data: Optional[SplitData] = None,
                  norm_stats: Optional[Dict] = None, **kwargs) -> Trainer:
    """A ``Trainer`` for ``ecg-vit-{model_size}`` with ``TrainConfig(**train_args)``
    (reference get_all_setup, train.py:439-468); ``kwargs`` go to ``Trainer``."""
    model_cfg = VitConfig.from_defined(f'ecg-vit-{model_size}')
    cfg = TrainConfig(**(train_args or {}))
    return Trainer(model_cfg, cfg, train_data=train_data, eval_data=eval_data,
                   norm_stats=norm_stats, **kwargs)
