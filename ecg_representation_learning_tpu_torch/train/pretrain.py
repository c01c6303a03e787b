"""MAE pretraining loop and pretrained-encoder transfer (the JAX
``train/pretrain.py``).

``MaeTrainer``: masked-patch pretraining of the shared encoder, with the
supervised trainer's loop mechanics -- the split resident on the device and
gathered by index, normalize + pad + crop, forward with dropout, backward
(microbatches summed for ``grad_accum``), the update tail of
``loop.finish_update`` (fused AdamW, non-finite counter, EMA), eval epochs
with a fixed mask generator, early stopping, best / periodic / final
checkpoints and resume.  The mask noise comes from the trainer's device
generator, so a checkpoint resumes exactly.  The streaming pair
(``build_stream_step``, ``train_stream``) is not ported and raises.

Then the handoff into ``EcgVit``: ``transfer_encoder`` copies the trunk,
``linear_probe_mask`` / ``make_probe_optimizer`` train the head alone.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import MaeConfig, TrainConfig, VitConfig
from ..models.mae import EcgMae
from .loop import grad_accum
from .optim import AdamChain, Schedule, make_optimizer
from .trainer import SplitData, TrainerBase, _prep_batch


class MaeTrainer(TrainerBase):
    """Self-supervised masked-patch pretrainer."""

    default_dir = 'mae'      # output_dir when none is given: runs/<default_dir>
    log_name = 'EcgMae'

    def __init__(self, model_cfg: VitConfig, mae_cfg: MaeConfig, train_cfg: TrainConfig,
                 train_data: Optional[SplitData] = None,
                 eval_data: Optional[SplitData] = None,
                 norm_stats: Optional[Dict[str, Any]] = None,
                 output_dir: Optional[str] = None, device=None):
        self.mae_cfg = mae_cfg
        super().__init__(self._build_model(model_cfg, mae_cfg), model_cfg, train_cfg,
                         train_data, eval_data, norm_stats,
                         output_dir or os.path.join('runs', self.default_dir),
                         self.log_name, f'{self.log_name} Pretrain', device)

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

    def _micro_loss(self, sig: torch.Tensor):
        """(metrics of one microbatch, its loss) in train mode."""
        out = self.model(self._model_input(sig), rng=self.rng)
        return {'loss': out.loss.detach()}, out.loss

    def train_step(self, data: SplitData, take: np.ndarray) -> Dict[str, Any]:
        """One optimizer step on the rows ``take`` of ``data``.  Returns the
        metrics (0-d device tensors, and the learning rate as a float)."""
        if not self.initialized:
            raise RuntimeError('call init_state() or set_params() first')
        sigs, idx = self._sig_inputs(data, take)
        self.model.train()
        aux, grads = grad_accum(lambda idx_k: self._micro_loss(sigs.index_select(0, idx_k)),
                                self.params(), idx, max(1, self.cfg.grad_accum))
        self.model.eval()
        metrics = {k: torch.stack([a[k] for a in aux]).mean() for k in aux[0]}
        lr = self.optimizer.lr_at(self.step)
        grad_norm = self._update(grads)
        return {**metrics, 'grad_norm': grad_norm, 'learning_rate': lr}

    @torch.inference_mode()
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
            sigs, idx = self._sig_inputs(data, take)
            x = self._model_input(sigs.index_select(0, idx))
            noise = torch.rand((bsz, x.shape[-1] // self.model_cfg.patch_size), generator=gen,
                               device=self.device)
            out = self._eval_forward(x, noise=noise)
            losses.append(out.per_sample_loss[:n_real].cpu().numpy())
        return float(np.concatenate(losses).mean())

    def build_stream_step(self, *args, **kwargs):
        raise NotImplementedError('not ported: streaming pretraining (build_stream_step)')

    def train_stream(self, *args, **kwargs):
        raise NotImplementedError('not ported: streaming pretraining (train_stream)')

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
