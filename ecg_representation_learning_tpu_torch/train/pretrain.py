"""MAE pretraining loop and pretrained-encoder transfer (the JAX
``train/pretrain.py``).

``MaeTrainer``: masked-patch pretraining of the shared encoder, with the
supervised trainer's loop mechanics -- the split resident on the device and
gathered by index, normalize + pad + crop, forward with dropout, backward
(microbatches summed for ``grad_accum``), the update tail of
``loop.finish_update`` (fused AdamW, non-finite counter, EMA), eval epochs
with a fixed mask generator, early stopping, best / periodic / final
checkpoints and resume.  The mask noise comes from the trainer's device
generator, so a checkpoint resumes exactly.

Streaming pretraining (``build_stream_step``, ``train_stream``): raw batches
(B, C, L) at a corpus's native rate, int16 counts or float32, from an
iterator (``data.pipeline.MixedRecordStream`` behind ``prefetch_to_device``)
-> wire decode ``counts / scale`` -> ``ops.preprocess.fused_train_path``
(resample + FIR low-pass + z-norm + pad) on the device -> crop -> the
masked forward and backward -> the update tail.  One step per
(native rate, wire scale) key; periodic ``ckpt-step{N}`` checkpoints and a
resume that continues a deterministic stream bit for bit.

Then the handoff into ``EcgVit``: ``transfer_encoder`` copies the trunk,
``linear_probe_mask`` / ``make_probe_optimizer`` train the head alone.

On a mesh (``mesh=``, as the supervised trainer) each rank takes its rows of
every (micro)batch and of every stream batch, the mask noise is drawn for
the global batch, and the eval losses are gathered over 'data'.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import MaeConfig, TrainConfig, VitConfig
from ..models.mae import EcgMae
from ..ops.preprocess import fused_train_path
from ..parallel import spmd
from .loop import grad_accum
from .checkpoint import wait_for_checkpoints
from .optim import AdamChain, Schedule, make_optimizer
from .trainer import SplitData, TrainerBase, _prep_batch, eval_mode


class MaeTrainer(TrainerBase):
    """Self-supervised masked-patch pretrainer."""

    default_dir = 'mae'      # output_dir when none is given: runs/<default_dir>
    log_name = 'EcgMae'

    def __init__(self, model_cfg: VitConfig, mae_cfg: MaeConfig, train_cfg: TrainConfig,
                 train_data: Optional[SplitData] = None,
                 eval_data: Optional[SplitData] = None,
                 norm_stats: Optional[Dict[str, Any]] = None,
                 output_dir: Optional[str] = None, device=None, mesh=None):
        self.mae_cfg = mae_cfg
        super().__init__(self._build_model(model_cfg, mae_cfg), model_cfg, train_cfg,
                         train_data, eval_data, norm_stats,
                         output_dir or os.path.join('runs', self.default_dir),
                         self.log_name, f'{self.log_name} Pretrain', device, mesh)

    def _build_model(self, model_cfg: VitConfig, mae_cfg: MaeConfig) -> torch.nn.Module:
        return EcgMae(model_cfg, mae_cfg)

    # ------------------------------------------------------------------ steps
    def _sig_inputs(self, data: SplitData, take: np.ndarray):
        """(signals, idx) on the device: the whole split when it fits
        ``hbm_split_max_bytes`` (or ``device_resident`` says so) and the real
        indices, else the copied batch and 0..n-1."""
        cfg = self.cfg
        resident = (cfg.device_resident if cfg.device_resident is not None
                    else data.signals.nbytes <= cfg.hbm_split_max_bytes)
        if resident:
            sigs = self._resident_split(data, lambda d: self._on_device(d.signals,
                                                                  self._signal_dtype))
            return sigs, self._to_device(take.astype(np.int64))
        return self._rows(data.signals, take), torch.arange(take.size, device=self.device)

    def _model_input(self, sig: torch.Tensor) -> torch.Tensor:
        """Normalize, pad, then crop to ``max_signal_length``: an input that
        is already a patch multiple gains a zero patch (the always-pad
        quirk) that would exceed the position embeddings."""
        sig = _prep_batch(sig.float(), self.mean, self.std, self.model_cfg.patch_size)
        return sig[..., :self.model_cfg.max_signal_length]

    def _micro_loss(self, sig: torch.Tensor, prep: Optional[Callable] = None):
        """(metrics of one microbatch, its objective) in train mode: the
        masked MSE, plus the weighted MoE aux loss for a MoE trunk (the
        metrics keep the MSE); ``prep`` makes the model input of ``sig``
        (default ``_model_input``).  The train step and the stream step both
        run it."""
        out = self._net((prep or self._model_input)(sig), rng=self.rng)
        return ({'loss': spmd.mean_over_data(out.loss.detach())},
                self._objective(out.loss, out.aux_loss))

    def train_step(self, data: SplitData, take: np.ndarray) -> Dict[str, Any]:
        """One optimizer step on the rows ``take`` of ``data``.  Returns the
        metrics (0-d device tensors, and the learning rate as a float)."""
        if not self.initialized:
            raise RuntimeError('call init_state() or set_params() first')
        accum = max(1, self.cfg.grad_accum)
        sigs, idx = self._sig_inputs(data, self._local_take(take, accum))
        self.model.train()
        with self._spmd():
            aux, grads = grad_accum(lambda idx_k: self._micro_loss(sigs.index_select(0, idx_k)),
                                    self.params(), idx, accum, self.sharded)
        self.model.eval()
        metrics = {k: torch.stack([a[k] for a in aux]).mean() for k in aux[0]}
        lr = self.optimizer.lr_at(self.step)
        grad_norm = self._update(grads)
        return {**metrics, 'grad_norm': grad_norm, 'learning_rate': lr}

    @eval_mode
    def evaluate(self, data: Optional[SplitData] = None, seed: int = 0) -> float:
        """Held-out masked-reconstruction loss with a fixed mask generator
        (seeded with ``seed``), so eval numbers compare across epochs and
        runs.  A short last batch is padded with row 0 to the eval batch
        size and only its real rows count."""
        data = data if data is not None else self.eval_data
        if data is None or len(data) == 0:
            raise ValueError('no eval data')
        if not self.initialized:
            self.init_state()
        bsz = self.cfg.eval_batch_size
        gen = torch.Generator(device=self.device).manual_seed(seed)
        losses = []
        for i in range(0, len(data), bsz):
            take = np.arange(i, min(i + bsz, len(data)))
            n_real = take.size
            if n_real < bsz:
                take = np.concatenate([take, np.zeros(bsz - n_real, np.int64)])
            sigs, idx = self._sig_inputs(data, self._local_take(take))
            x = self._model_input(sigs.index_select(0, idx))
            noise = torch.rand((bsz, x.shape[-1] // self.model_cfg.patch_size), generator=gen,
                               device=self.device)
            out = self._eval_forward(x, noise=noise[self._rows(bsz)])
            with self._spmd():
                per_sample = spmd.gather_rows(out.per_sample_loss)
            losses.append(per_sample[:n_real].cpu().numpy())
        return float(np.concatenate(losses).mean())

    # ---------------------------------------------------------------- stream
    def _stream_prep(self, raw_fqs: Optional[int]) -> Callable[[torch.Tensor], torch.Tensor]:
        """The model input of a decoded stream batch: at a native rate other
        than 250 Hz the fused resample + low-pass + normalize + pad, else
        normalize + pad; then the crop to ``max_signal_length``."""
        if raw_fqs is None or raw_fqs == 250:
            return self._model_input
        cfg = self.model_cfg

        def prep(sig: torch.Tensor) -> torch.Tensor:
            x = fused_train_path(sig.float(), self.mean, self.std, fqs=raw_fqs, target_fqs=250,
                                 patch_size=cfg.patch_size)
            return x[..., :cfg.max_signal_length]
        return prep

    def _rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (all of them on one
        device)."""
        if self.mesh is None:
            return slice(None)
        from ..parallel.distributed import process_local_batch_slice
        return process_local_batch_slice(n, self.mesh)

    def build_stream_step(self, raw_fqs: Optional[int] = None,
                          wire_scale: Optional[float] = None
                          ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
        """The streaming-pretrain step for one corpus spec: ``step(sig)``
        takes a raw (B, C, L) device batch (int16 counts when ``wire_scale``
        is set, decoded as ``counts / wire_scale`` in f32), runs the
        preprocess of ``_stream_prep(raw_fqs)``, the forward and backward on
        the whole batch, and the update tail; returns the metrics as 0-d
        device tensors (no host sync).  Exposed so ``train_stream`` and a
        benchmark time the same step.  On a mesh ``sig`` is this rank's rows
        of the global batch (``train_stream`` cuts them, or
        ``prefetch_to_device(sharding=mesh)`` moved only them)."""
        prep = self._stream_prep(raw_fqs)
        scale = (None if wire_scale is None else
                 torch.tensor(wire_scale, dtype=torch.float32, device=self.device))

        def stream_step(sig: torch.Tensor) -> Dict[str, torch.Tensor]:
            if not self.initialized:
                raise RuntimeError('call init_state() or set_params() first')
            if scale is not None:
                sig = sig.float() / scale          # a true f32 division, as JAX's
            self.model.train()
            with self._spmd():
                aux, grads = grad_accum(lambda _: self._micro_loss(sig, prep), self.params(),
                                        torch.zeros(1), 1, self.sharded)
            self.model.eval()
            grad_norm = self._update(grads)
            return {**aux[0], 'grad_norm': grad_norm}
        return stream_step

    def train_stream(self, batches: Iterable, total_steps: int,
                     raw_fqs: Union[None, int, Sequence[Optional[int]]] = None,
                     log_every: int = 50,
                     wire_scale: Union[None, float, Sequence[Optional[float]]] = None,
                     ckpt_every: int = 0, resume: Union[bool, str] = False,
                     local_batches: bool = False) -> Dict[str, Any]:
        """Streaming pretraining over an iterator of raw (B, C, L) batches
        (host arrays or device tensors, e.g. ``prefetch_to_device`` over a
        :class:`data.pipeline.MixedRecordStream`), up to ``total_steps``
        optimizer steps.

        Items may be ``(corpus_idx, batch)`` pairs; ``raw_fqs`` and
        ``wire_scale`` are then per-corpus sequences, and each distinct
        (rate, scale) key gets its own step (``build_stream_step``): the key,
        not the batch shape, chooses the preprocess.  ``raw_fqs`` None: the
        batches are on the 250 Hz grid already.  ``wire_scale``: the batches
        are integer counts, decoded on the device.

        ``ckpt_every``: save ``ckpt-step{N}`` every N steps and keep the
        newest two, plus a final save when the last step was not saved.
        ``resume``: True restores the newest checkpoint under output_dir (a
        string: that checkpoint) -- parameters, moments, EMA, step and the
        generators -- and skips the batches already consumed, so a
        deterministic stream continues bit for bit.  On a mesh each rank takes
        its rows of every batch, or, with ``local_batches``, the batches are
        already its rows (``prefetch_to_device(sharding=mesh)``).  Returns
        ``{'loss', 'steps', 'mix_counts', 'timer'}``.
        """
        import itertools

        from ..utils.misc import StepTimer
        from .checkpoint import prune_checkpoints
        start_step = 0
        if resume:
            path = resume if isinstance(resume, str) else self.latest_checkpoint()
            if path:
                self.load_checkpoint(path)
                start_step = self.step
                self._info(f'Resumed streaming pretrain from {path} (step {start_step})')
        if not self.initialized:
            self.init_state()
        if ckpt_every:
            os.makedirs(self.output_dir, exist_ok=True)

        def per_corpus(v, ci):
            return v[ci] if isinstance(v, (list, tuple)) else v

        step_fns: Dict[Any, Callable] = {}

        def step_for(ci: int):
            key = (per_corpus(raw_fqs, ci), per_corpus(wire_scale, ci))
            if key not in step_fns:
                step_fns[key] = self.build_stream_step(raw_fqs=key[0], wire_scale=key[1])
            return step_fns[key]

        timer = StepTimer()
        last_loss = float('nan')
        host_step = start_step
        saved_at = -1
        mix_counts: Dict[int, int] = {}
        for item in itertools.islice(batches, start_step, total_steps):
            ci, batch = item if isinstance(item, tuple) else (0, item)
            sig = torch.as_tensor(batch, device=self.device)
            if not local_batches:
                sig = sig[self._rows(sig.shape[0])]
            timer.input_done()
            metrics = step_for(ci)(sig)
            timer.step_done()
            mix_counts[ci] = mix_counts.get(ci, 0) + 1
            host_step += 1
            if host_step % log_every == 0 or host_step == total_steps:
                last_loss = float(metrics['loss'])
                self._info(str({'pretrain/loss': last_loss, 'step': host_step,
                                **timer.summary()}))
            if ckpt_every and host_step % ckpt_every == 0:
                # step-tagged: each save targets a fresh path, so a crash
                # mid-write never deletes the previous committed checkpoint
                self.save_checkpoint(tag=f'step{host_step}')
                prune_checkpoints(self.output_dir, keep=2)
                saved_at = host_step
        if ckpt_every and host_step != saved_at:
            self.save_checkpoint(tag=f'step{host_step}')
            prune_checkpoints(self.output_dir, keep=2)
        wait_for_checkpoints()   # every save committed before returning
        return {'loss': last_loss, 'steps': host_step,
                'mix_counts': {int(k): v for k, v in sorted(mix_counts.items())},
                'timer': timer.summary()}

    # ------------------------------------------------------------------ loop
    def train(self, resume: Union[bool, str] = False) -> Dict[str, Any]:
        """Epoch-loop pretraining with eval epochs, early stopping, periodic /
        best / final checkpoints and resume (True: the newest checkpoint
        under output_dir; a string: that checkpoint)."""
        cfg = self.cfg
        os.makedirs(self.output_dir, exist_ok=True)
        if resume:
            path = resume if isinstance(resume, str) else self.latest_checkpoint()
            if path:
                self.load_checkpoint(path)
                self._info(f'Resumed from {path} (epoch {self.epoch})')
        self._open_sinks(f'{self.log_name} PretrainFile', 'pretrain.log')
        if not self.initialized:
            self.init_state()
        host_rng = np.random.default_rng(cfg.seed)
        n = len(self.train_data)
        t0 = time.time()
        last_loss = None
        best_eval_loss, n_bad_ep = float('inf'), 0
        eval_history = []
        self._nonfinite.zero_()
        log_every = max(1, self.steps_per_epoch // 4)
        for _ in range(self.epoch, cfg.num_train_epoch):
            self.epoch += 1
            idx = np.arange(n)
            host_rng.shuffle(idx)
            stop = (n // cfg.train_batch_size) * cfg.train_batch_size
            for i in range(0, stop, cfg.train_batch_size):
                metrics = self.train_step(self.train_data, idx[i:i + cfg.train_batch_size])
                if self.step % log_every == 0:
                    self._check_finite(f'by step {self.step}')
                    last_loss = float(metrics['loss'])
                    payload = {'pretrain/loss': last_loss,
                               'pretrain/lr': float(metrics['learning_rate']),
                               'pretrain/grad_norm': float(metrics['grad_norm']),
                               'epoch': self.epoch, 'step': self.step}
                    # objective-specific extras (the contrastive accuracy)
                    payload.update({f'pretrain/{k}': float(v) for k, v in metrics.items()
                                    if k not in ('loss', 'learning_rate', 'grad_norm')})
                    self._log(payload)
            self._check_finite(f'during epoch {self.epoch}')
            if cfg.save_every_n_epoch and self.epoch % cfg.save_every_n_epoch == 0:
                self.save_checkpoint(tag=f'ep{self.epoch}')
            if cfg.do_eval and self.eval_data is not None and len(self.eval_data):
                ev = self.evaluate()
                eval_history.append(ev)
                self._log({'pretrain/eval_loss': ev, 'epoch': self.epoch, 'step': self.step})
                if ev < best_eval_loss:
                    best_eval_loss, n_bad_ep = ev, 0
                    self.save_checkpoint(tag='best')
                else:
                    n_bad_ep += 1
                if n_bad_ep >= cfg.patience:
                    self._info(f'Pretraining stopped early at epoch {self.epoch} '
                               f'(patience {cfg.patience})')
                    break
        self.tb.close()
        path = self.save_checkpoint(tag='final') if cfg.save_final else None
        wait_for_checkpoints()   # every save committed before returning
        return {'loss': float('nan') if last_loss is None else last_loss,
                'epochs': self.epoch, 'eval_history': eval_history,
                'best_eval_loss': best_eval_loss if eval_history else None,
                'seconds': time.time() - t0, 'checkpoint': path}


# ---------------------------------------------------------------------------
# Pretrained-encoder transfer
# ---------------------------------------------------------------------------
def transfer_encoder(mae_params: Mapping[str, torch.Tensor],
                     vit_params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``EcgVit`` state_dict ``vit_params`` with the MAE trunk copied in.

    encoder_patch_embed -> encoder.patch_embed, encoder_blocks.i ->
    encoder.blocks.i, encoder_norm -> encoder.final_norm, encoder_pos_embed
    (P rows) -> rows 1..P of encoder.pos_embed (the cls row keeps its init).
    The head and cls token stay as they are.  Returns new tensors; the
    arguments are not changed."""
    out = {k: v.detach().clone() for k, v in vit_params.items()}
    renames = (('encoder_patch_embed.', 'encoder.patch_embed.'),
               ('encoder_blocks.', 'encoder.blocks.'),
               ('encoder_norm.', 'encoder.final_norm.'))
    for key, val in mae_params.items():
        for src, dst in renames:
            if key.startswith(src):
                name = dst + key[len(src):]
                if name not in out or out[name].shape != val.shape:
                    raise ValueError(f'MAE param {key} has no counterpart {name} of shape '
                                     f'{tuple(val.shape)} in this model -- wrong model size?')
                out[name] = val.detach().clone().to(out[name].device)
    pos = mae_params['encoder_pos_embed']
    out['encoder.pos_embed'][:, 1:1 + pos.shape[1]] = pos.to(out['encoder.pos_embed'].device)
    return out


def linear_probe_mask(params: Iterable[str]) -> Dict[str, bool]:
    """True (trainable) only for the classification head's parameters --
    the linear-probe protocol on a frozen pretrained trunk."""
    return {name: 'head' in name for name in params}


def make_probe_optimizer(cfg: TrainConfig, total_steps: int, params: Iterable[str]
                         ) -> Tuple[AdamChain, Schedule]:
    """AdamW on the head only: the optax chain (``fused_optimizer=False``)
    with every other parameter's updates zeroed.  Returns (optimizer,
    schedule)."""
    opt, sched = make_optimizer(dataclasses.replace(cfg, fused_optimizer=False), total_steps)
    opt.trainable = frozenset(k for k, m in linear_probe_mask(params).items() if m)
    return opt, sched


def load_pretrained_encoder(path: str, model_cfg: VitConfig,
                            mae_cfg: Optional[MaeConfig] = None) -> Dict[str, torch.Tensor]:
    """The parameters of an MAE checkpoint (``cli pretrain`` / ``MaeTrainer``
    output), for :func:`transfer_encoder`; checked against ``EcgMae(model_cfg,
    mae_cfg)`` (the default decoder unless given)."""
    from .checkpoint import check_params, restore_checkpoint
    params = restore_checkpoint(path)['params']
    with torch.device('meta'):
        model = EcgMae(model_cfg, mae_cfg or MaeConfig())
    check_params(params, model.state_dict(), f'MAE checkpoint {path}')
    return params
