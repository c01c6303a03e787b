"""The training and evaluation harness (the JAX package's ``Trainer``).

  * one train step: gather the minibatch rows from the device-resident
    split by index -> normalize + pad (+ TimeOut) -> forward with dropout ->
    BCE -> backward (microbatches summed for ``grad_accum``) -> global norm
    and the device-side non-finite counter -> the fused AdamW kernel -> the
    parameter EMA.  No step waits for the device unless a metric is logged;
  * host shuffling with ``np.random.default_rng(cfg.seed)``, the same batch
    order as JAX, and the last partial batch dropped;
  * eval epochs (per-sample losses, binary stats, macro-AUROC), early
    stopping on the eval loss with ``patience``, best and final checkpoints,
    resume from a checkpoint;
  * inference (``predict``, ``predict_long``), as the JAX ``eval_step``:
    z-normalize, ``time_end_pad``, forward, sigmoid, every batch padded to
    ``eval_batch_size`` (with copies of row 0) and trimmed, so the device
    always sees one batch shape.

Evaluation and inference serve the EMA weights when ``cfg.ema_decay > 0``.
Randomness: model init from a CPU generator seeded with ``cfg.seed``; dropout
seeds (attention kernel, hashed masks) from a host generator and Bernoulli
masks and TimeOut draws from a generator on the device, both seeded from
``cfg.seed`` and checkpointed.
"""
from __future__ import annotations

import dataclasses
import datetime
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
from ..ops.augment import timeout as timeout_op
from ..ops.dropout import DropoutRng
from ..ops.pad import time_end_pad
from ..runtime import default_device
from ..utils.logging import TbWriter, get_logger, pretty_log_dict
from .loop import finish_update, grad_accum
from .metrics import binary_stats, classification_report, multilabel_auroc, per_class_recall
from .optim import FusedAdamWState, make_optimizer


@dataclasses.dataclass
class SplitData:
    """One split: raw signals + multi-hot labels."""
    signals: np.ndarray   # (N, C, L) float32, unnormalized (raw 250 Hz grid)
    labels: np.ndarray    # (N, num_class) float32 multi-hot

    def __len__(self):
        return self.signals.shape[0]


def _prep_batch(sig: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                patch_size: int, train: bool = False,
                generator: Optional[torch.Generator] = None,
                timeout_scale=(0.0, 0.5)) -> torch.Tensor:
    """Per-batch transform: normalize -> pad -> (``train``) TimeOut."""
    sig = (sig - mean.reshape(-1, 1)) / std.reshape(-1, 1)
    sig = time_end_pad(sig, patch_size)
    if train:
        sig = timeout_op(sig, *timeout_scale, generator=generator)
    return sig


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal (at +-2 std) with
    variance 1/fan_in after truncation."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class Trainer:
    """Supervised multi-label trainer (the reference MyTrainer equivalent)."""

    def __init__(self, model_cfg: VitConfig, train_cfg: TrainConfig,
                 train_data: Optional[SplitData] = None,
                 eval_data: Optional[SplitData] = None,
                 norm_stats: Optional[Dict[str, Any]] = None,
                 output_dir: Optional[str] = None, name: str = 'EcgVit', device=None):
        self.device = default_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.name = name
        self.model = EcgVit(model_cfg).eval()
        self.train_data, self.eval_data = train_data, eval_data
        stats = norm_stats or {'mean': [0.0] * model_cfg.num_channels,
                               'std': [1.0] * model_cfg.num_channels}
        self.mean = torch.tensor(stats['mean'], dtype=torch.float32, device=self.device)
        self.std = torch.tensor(stats['std'], dtype=torch.float32, device=self.device)
        self.save_time = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
        self.output_dir = output_dir or os.path.join('runs', self.save_time)

        if train_cfg.train_batch_size % max(1, train_cfg.grad_accum):
            raise ValueError(f'grad_accum {train_cfg.grad_accum} must divide '
                             f'train_batch_size {train_cfg.train_batch_size}')
        n_train = len(train_data) if train_data is not None else 1
        self.steps_per_epoch = train_cfg.steps_per_epoch(n_train)
        self.total_steps = train_cfg.total_steps(n_train)
        self.optimizer, self.schedule = make_optimizer(train_cfg, self.total_steps)

        self.initialized = False
        self.opt_state: Optional[FusedAdamWState] = None
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self.rng: Optional[DropoutRng] = None
        self.step = 0         # optimizer steps taken, on the host
        self.epoch = 0
        self._nonfinite = torch.zeros((), dtype=torch.int32, device=self.device)
        self._resident = {}   # id(SplitData) -> (signals, labels) on the device
        self.last_restore_info: Dict[str, Any] = {}
        self.logger = get_logger(f'{name} Train')
        self.logger_fl = None
        self.tb = None

    # ------------------------------------------------------------------ setup
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    def _reset_run_state(self, seed: int) -> None:
        """Generators from ``seed``, step 0, fresh optimizer state and EMA."""
        host = torch.Generator().manual_seed(seed)
        dev = torch.Generator(device=self.device)
        dev.manual_seed(int(torch.randint(0, 1 << 62, (1,), generator=host)))
        self.rng = DropoutRng(host=host, device=dev)
        self.step = 0
        self._reset_optimizer()

    def _reset_optimizer(self) -> None:
        params = {k: p.detach() for k, p in self.params().items()}
        self.opt_state = self.optimizer.init(params)
        self.ema = ({k: p.clone() for k, p in params.items()}
                    if self.cfg.ema_decay > 0 else None)

    def init_state(self, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Seeded init with flax's distributions: lecun-normal Linear weights,
        zero biases, unit LayerNorm scales, normal(0.02) cls and pos tokens.
        Drawn on the CPU from one ``torch.Generator``, so the weights do not
        depend on the device.  Resets the optimizer state, the EMA, the step
        and the dropout generators."""
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        self.model.to('cpu')
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if name.endswith(('cls_token', 'pos_embed')):
                    torch.nn.init.normal_(p, 0.0, 0.02, generator=gen)
                elif name.endswith('bias'):
                    p.zero_()
                elif p.dim() == 2:
                    _lecun_normal_(p, gen)
                else:
                    p.fill_(1.0)
        self.model.to(self.device)
        self._reset_run_state(seed)
        self.initialized = True
        self._info(f'initialized {self.model_cfg.meta} on {self.device}')
        return self.model.state_dict()

    def set_params(self, state_dict: Mapping[str, torch.Tensor]):
        """Install an externally built state_dict (e.g. flax params carried
        over with ``models.port.vit_state_dict_from_flax``), re-initializing
        the optimizer state and re-seeding the EMA from it."""
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device)
        if self.rng is None:
            self._reset_run_state(self.cfg.seed)
        else:
            self._reset_optimizer()
        self.initialized = True
        self._info(f'loaded weights into {self.model_cfg.meta} on {self.device}')
        return self.model.state_dict()

    def _info(self, msg: str) -> None:
        if self.cfg.log_to_console:
            self.logger.info(msg)

    # ------------------------------------------------------------------ steps
    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the device, copied without waiting for it."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _split_arrays(self, data: SplitData):
        """The split as device tensors when it fits ``hbm_split_max_bytes``
        (or ``device_resident`` says so), so a step gathers its rows on the
        device from an index vector; else None (each batch is copied)."""
        cfg = self.cfg
        resident = (cfg.device_resident if cfg.device_resident is not None
                    else data.signals.nbytes + data.labels.nbytes <= cfg.hbm_split_max_bytes)
        if not resident:
            return None
        key = id(data)
        if key not in self._resident:
            self._resident[key] = (
                torch.as_tensor(np.asarray(data.signals, np.float32), device=self.device),
                torch.as_tensor(np.asarray(data.labels, np.float32), device=self.device))
            # evict with the SplitData: a reused id() must not alias a new split
            weakref.finalize(data, self._resident.pop, key, None)
        return self._resident[key]

    def _step_inputs(self, data: SplitData, take: np.ndarray):
        """(signals, labels, idx) on the device: the whole resident split and
        the real indices, or the copied batch and 0..n-1."""
        dev = self._split_arrays(data)
        if dev is not None:
            sigs, labs = dev
            return sigs, labs, self._to_device(take.astype(np.int64))
        sigs = self._to_device(np.asarray(data.signals[take], np.float32))
        labs = self._to_device(np.asarray(data.labels[take], np.float32))
        return sigs, labs, torch.arange(take.size, device=self.device)

    def train_step(self, data: SplitData, take: np.ndarray) -> Dict[str, Any]:
        """One optimizer step on the rows ``take`` of ``data``.  Returns the
        metrics (0-d device tensors, and the learning rate as a float)."""
        if not self.initialized:
            raise RuntimeError('call init_state() or set_params() first')
        cfg = self.cfg
        sigs, labs, idx = self._step_inputs(data, take)
        params = self.params()
        self.model.train()

        def micro(idx_k):
            sig = sigs.index_select(0, idx_k).float()
            lab = labs.index_select(0, idx_k)
            sig = _prep_batch(sig, self.mean, self.std, self.model_cfg.patch_size,
                              train=cfg.augment_timeout, generator=self.rng.device)
            out = self.model(sig, labels=lab, loss_weight=cfg.loss_weight, rng=self.rng)
            return (out.loss.detach(), out.logits.detach(), lab), out.loss

        aux, grads = grad_accum(micro, params, idx, max(1, cfg.grad_accum))
        self.model.eval()
        loss = torch.stack([a[0] for a in aux]).mean()
        logits = torch.cat([a[1] for a in aux])
        lab = torch.cat([a[2] for a in aux])
        lr = self.optimizer.lr_at(self.step)
        self.opt_state, grad_norm, self._nonfinite = finish_update(
            self.optimizer, cfg, self.opt_state, {k: p.detach() for k, p in params.items()},
            grads, self._nonfinite, self.ema)
        for p in params.values():
            p.grad = None
        self.step += 1
        probs = torch.sigmoid(logits.float())
        return {'loss': loss, 'learning_rate': lr, 'grad_norm': grad_norm,
                **binary_stats(probs, lab)}

    def _check_finite(self, where: str) -> None:
        if self.cfg.debug_nans and int(self._nonfinite) > 0:
            # the reference's grad-clip error_if_nonfinite (train.py:281): the
            # device counter catches every step, raised at this host sync
            raise FloatingPointError(
                f'non-finite gradient norm {where} ({int(self._nonfinite)} bad '
                f'steps; params unpoisoned)')

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

    def latest_checkpoint(self) -> Optional[str]:
        """Most recent committed ``ckpt-*`` under output_dir."""
        from .checkpoint import latest_committed_checkpoint
        return latest_committed_checkpoint(self.output_dir)

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
        self.logger_fl = get_logger(f'{self.name} TrainFile',
                                    file_path=os.path.join(self.output_dir, 'train.log'))
        self.tb = TbWriter(os.path.join(self.output_dir, 'tb'))
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
        for _ in range(self.epoch, cfg.num_train_epoch):
            self.epoch += 1
            for take, _ in self._index_batches(self.train_data, cfg.train_batch_size,
                                               shuffle_rng=host_rng):
                metrics = self.train_step(self.train_data, take)
                if (not cfg.log_per_epoch) or self.step % self.steps_per_epoch == 0:
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
        if cfg.save_final:
            self.save_checkpoint(tag='final')
        dt = time.time() - t_start
        self._info(f'Training completed in {dt:.1f}s')
        self.tb.close()
        return {'best_eval_loss': best_eval_loss, 'history': history,
                'epochs': self.epoch, 'seconds': dt}

    # -------------------------------------------------------------- inference
    def _eval_forward(self, sig: torch.Tensor, **kw):
        """The eval-mode forward on the served weights: the EMA when
        ``cfg.ema_decay > 0``, else the trained parameters."""
        self.model.eval()
        if self.ema is not None:
            return torch.func.functional_call(self.model, self.ema, (sig,), kw)
        return self.model(sig, **kw)

    @torch.inference_mode()
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
            sigs, labs, idx = self._step_inputs(data, take)
            sig = _prep_batch(sigs.index_select(0, idx).float(), self.mean, self.std,
                              self.model_cfg.patch_size)
            out = self._eval_forward(sig, labels=labs.index_select(0, idx),
                                     loss_reduction='none')
            losses.append(out.loss[:n_real].cpu().numpy())
            probs_all.append(torch.sigmoid(out.logits.float())[:n_real].cpu().numpy())
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

    @torch.inference_mode()
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
            sig = torch.from_numpy(data.signals[take]).to(self.device)
            sig = _prep_batch(sig, self.mean, self.std, self.model_cfg.patch_size)
            probs = torch.sigmoid(self._eval_forward(sig).logits.float())
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

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, tag: str = 'final') -> str:
        from .checkpoint import save_checkpoint
        path = os.path.join(os.path.abspath(self.output_dir), f'ckpt-{tag}')
        state = {'step': self.step, 'epoch': self.epoch,
                 'params': self.model.state_dict(),
                 'opt_state': {'count': self.opt_state.count, 'mu': self.opt_state.mu,
                               'nu': self.opt_state.nu},
                 'rng': {'host': self.rng.host.get_state(),
                         'device': self.rng.device.get_state()}}
        if self.ema is not None:
            state['ema_params'] = self.ema
        save_checkpoint(path, state)
        self._info(f'Checkpoint saved to {path}')
        return path

    def load_checkpoint(self, path: str):
        """Restore a checkpoint of this model: params, step, epoch, the
        generators, and -- when they match this trainer -- the optimizer
        state (else it is re-initialized, with a warning) and the EMA
        (seeded from the params when the checkpoint has none; dropped, and
        ``last_restore_info['dropped_ema']`` set, when this trainer keeps
        none)."""
        from .checkpoint import restore_checkpoint
        log = logging.getLogger(__name__)
        if not self.initialized:
            self.init_state()
        raw = restore_checkpoint(path)
        try:
            self.model.load_state_dict(raw['params'], strict=True)
        except RuntimeError as e:
            raise ValueError(f'checkpoint {path} params do not match this model '
                             f'(wrong model size/config?): {e}') from None
        self.model.to(self.device)
        params = {k: p.detach() for k, p in self.params().items()}
        self._reset_optimizer()
        opt = raw['opt_state']
        fresh = self.opt_state
        if all(k in opt[m] and opt[m][k].shape == getattr(fresh, m)[k].shape
               and opt[m][k].dtype == getattr(fresh, m)[k].dtype
               for m in ('mu', 'nu') for k in params):
            self.opt_state = FusedAdamWState(
                count=int(opt['count']),
                mu={k: opt['mu'][k].to(self.device) for k in params},
                nu={k: opt['nu'][k].to(self.device) for k in params})
        else:
            log.warning('optimizer state in %s does not match this trainer (e.g. '
                        'another adam_mu_dtype); reinitialized it', path)
        extra: Dict[str, Any] = {'epoch': int(raw['epoch'])}
        if self.ema is not None:
            if 'ema_params' not in raw:
                log.warning('checkpoint %s has no EMA; seeding it from the params', path)
            self.ema = {k: v.to(self.device).clone()
                        for k, v in raw.get('ema_params', raw['params']).items()}
        elif 'ema_params' in raw:
            log.warning('checkpoint %s carries EMA params this trainer does not '
                        'track (ema_decay=0); dropping them', path)
            extra['dropped_ema'] = True
        self.rng.host.set_state(raw['rng']['host'])
        self.rng.device.set_state(raw['rng']['device'])
        self.step = int(raw['step'])
        self.epoch = int(raw['epoch'])
        self.last_restore_info = extra
        return self.model.state_dict()

    # ----------------------------------------------------------------- logging
    def _log(self, payload: Dict[str, Any]):
        pretty = pretty_log_dict(payload)
        if self.cfg.log_to_console:
            self.logger.info(str(pretty))
        if self.logger_fl:
            self.logger_fl.info(str(pretty))
        if self.tb:
            self.tb.log(payload, step=self.step)

    def _log_epoch(self, metrics: Dict[str, Any], prefix: str):
        payload = {f'{prefix}/{k}': v for k, v in metrics.items()
                   if k not in ('per_sample_loss', 'predictions', 'history',
                                'classification_report')}
        payload.update(epoch=self.epoch, step=self.step)
        self._log(payload)
