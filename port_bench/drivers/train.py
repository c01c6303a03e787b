"""Driver of the supervised cells: the port's ``Trainer`` on a training split
resident on the card, K steps a dispatch (``train.dispatch.Dispatcher``,
CUDA graphs of K steps) or one step a call (``Trainer.train_step``).

Set-up makes the split and the weights from the seed, builds the trainer,
and runs the check's steps through the window's own calls: the first step
alone (so the optimizer's state after one step can be read), then, with K
> 1, two dispatches (the first runs eagerly and captures the graph, the
second replays it), else two more single steps.  The window then continues
the same batch order, epoch after epoch as ``Trainer.train()`` draws it,
with the host read of the metrics ``train()`` makes after each dispatch or
step, until the deadline.  The reference follows the check's steps from the
same weights and rows once the window has closed.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from .. import checks, inputs, yardstick
from ..reference import model as ref
from ..trace import Trace

VIT_KEYS = ('max_signal_length', 'patch_size', 'num_channels', 'hidden_size',
            'num_hidden_layers', 'num_attention_heads', 'intermediate_size',
            'hidden_dropout_prob', 'attention_probs_dropout_prob', 'num_class', 'pool',
            'patch_norm', 'dtype')
TRACE_S = 1.5          # the traced slice's length, at least
TRACE_UNITS = 4        # ... and its dispatches or steps, at least


def vit_config(config: dict):
    from ecg_representation_learning_tpu_torch.configs import VitConfig
    return VitConfig(**{k: config[k] for k in VIT_KEYS if k in config})


def train_config(config: dict, traffic: dict, seed: int, **extra):
    from ecg_representation_learning_tpu_torch.configs import TrainConfig
    t = config['train']
    return TrainConfig(
        num_train_epoch=traffic['epochs'], train_batch_size=traffic['batch_size'],
        eval_batch_size=traffic['batch_size'], learning_rate=t['learning_rate'],
        weight_decay=t['weight_decay'], schedule=t['schedule'],
        warmup_ratio=t['warmup_ratio'], grad_clip_norm=t['grad_clip_norm'],
        augment_timeout=t['augment_timeout'], ema_decay=t['ema_decay'],
        adam_mu_dtype=t['adam_mu_dtype'], seed=seed, do_eval=False, save_final=False,
        log_to_console=False, **extra)


class Batches:
    """``Trainer.train()``'s batch order: each epoch a shuffle of the split
    by ``np.random.default_rng(seed)``, cut into full batches."""

    def __init__(self, n: int, bsz: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.n, self.bsz, self.steps = n, bsz, n // bsz
        self._epoch()

    def _epoch(self) -> None:
        self.idx = np.arange(self.n)
        self.rng.shuffle(self.idx)
        self.pos = 0

    def left(self) -> int:
        return self.steps - self.pos

    def take(self, k: int) -> np.ndarray:
        out = self.idx[self.pos * self.bsz:(self.pos + k) * self.bsz].reshape(k, self.bsz)
        self.pos += k
        if self.pos == self.steps:
            self._epoch()
        return out


def host_read(metrics: Dict) -> Dict[str, float]:
    """The host read ``Trainer.train()`` makes of a step's or a dispatch's
    metrics (it waits for the device)."""
    return {k: float(v) for k, v in metrics.items()}


def check_rows(r) -> np.ndarray:
    """The rows of the check's steps, in order: 1 + 2 K batches of
    ``train()``'s order."""
    k, bsz = r.traffic['steps_per_dispatch'], r.traffic['batch_size']
    batches = Batches(r.traffic['train_records'], bsz, r.seed)
    return batches.take(1 + 2 * k).reshape(-1)


def setup(r):
    """The split, the trainer with the seed's weights, and the check's steps
    run through the window's calls.  Returns (state, the program's readings,
    the rows of the check's steps)."""
    from ecg_representation_learning_tpu_torch.train import SplitData, Trainer
    from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher
    cfg, traffic, dev = r.config, r.traffic, r.device
    k, bsz = traffic['steps_per_dispatch'], traffic['batch_size']
    sig, lab = inputs.ptbxl_split(traffic['train_records'], cfg['num_channels'],
                                  cfg['record_samples'], cfg['num_class'], r.seed, dev)
    w0 = inputs.weights(ref.vit_shapes(cfg), r.seed, dev)
    data = SplitData(signals=sig, labels=lab)
    tr = Trainer(vit_config(cfg), train_config(cfg, traffic, r.seed, steps_per_dispatch=k),
                 train_data=data, norm_stats=cfg['norm_stats'], output_dir=r.scratch('run'),
                 device=dev)
    tr.set_params(w0)
    batches = Batches(len(data), bsz, r.seed)

    first = batches.take(1)
    losses = [float(tr.train_step(data, first[0])['loss'])]
    grad1 = checks.leaf_norms(tr.opt_state.mu, 1.0 / (1.0 - cfg['train']['b1']))
    takes = [first]
    disp = Dispatcher(tr, k, scan=False) if k > 1 else None
    for _ in range(2):
        t = batches.take(k)
        if disp is not None:
            losses += disp.run(t)[0].tolist()
        else:
            losses.append(float(tr.train_step(data, t[0])['loss']))
        takes.append(t)
    delta = checks.leaf_norms({n: p.detach() - w0[n] for n, p in tr.model.named_parameters()})
    rows = np.concatenate(takes).reshape(-1)
    state = {'tr': tr, 'disp': disp, 'data': data, 'batches': batches, 'sig': sig, 'lab': lab}
    return state, {'losses': losses, 'grad1': grad1, 'delta': delta}, rows


def run(r) -> None:
    cfg, traffic, dev = r.config, r.traffic, r.device
    k, bsz = traffic['steps_per_dispatch'], traffic['batch_size']
    st, prog, rows = setup(r)
    tr, disp, data, batches = st['tr'], st['disp'], st['data'], st['batches']
    idx = torch.as_tensor(rows, device=dev)
    check_sig, check_lab = st['sig'][idx].clone(), st['lab'][idx].clone()

    def unit() -> int:
        """One dispatch of K steps, or one step where the epoch has fewer
        than K left (``train()``'s leftover steps), with its host read."""
        if disp is not None and batches.left() >= k:
            host_read(disp.run(batches.take(k))[2])
            return k
        host_read(tr.train_step(data, batches.take(1)[0]))
        return 1

    t0 = r.start_window()
    steps = 0
    while time.perf_counter() - t0 < r.seconds:
        steps += unit()
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    r.e2e[traffic['metric']] = steps * bsz / wall
    r.window = {'steps': steps, 'samples': steps * bsz, 'seconds': wall,
                'flops_per_sample': yardstick.train_flops_per_sample(cfg),
                'params': yardstick.param_count(ref.vit_shapes(cfg))}
    r.attempted = steps
    if r.trace:
        with Trace(dev) as tr_slice:
            t1, n = time.perf_counter(), 0
            while n < TRACE_UNITS or time.perf_counter() - t1 < TRACE_S:
                n += unit()
            tr_slice.units = n
        r.tr = tr_slice
    if dev.type == 'cuda':
        r.memory_peak = torch.cuda.max_memory_allocated(dev)
    total = tr.total_steps
    del st, tr, disp, data
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    base = follow(r, check_sig, check_lab, len(prog['losses']), total, 'f32')
    r.checks = checks.judged(checks.gaps(prog, base), r.cell['limits'])


def follow(r, sig: torch.Tensor, lab: torch.Tensor, steps: int, total: int, mode: str,
           half: bool = False) -> dict:
    """The reference's run of the check's ``steps`` steps on ``sig``/``lab``
    (the steps' rows in order), from the seed's weights."""
    cfg = r.config
    mean = torch.tensor(cfg['norm_stats']['mean'], device=sig.device).reshape(-1, 1)
    std = torch.tensor(cfg['norm_stats']['std'], device=sig.device).reshape(-1, 1)
    bsz = sig.shape[0] // steps

    def batch(s):
        def make():
            x = (sig[s * bsz:(s + 1) * bsz] - mean) / std
            return checks.time_end_pad(x, cfg['patch_size']), lab[s * bsz:(s + 1) * bsz]
        return make

    def loss_fn(p, x, y, draws, mode, half):
        logits = ref.vit_logits(p, x, cfg, draws, mode)
        n = x.shape[0] // 2 if half else x.shape[0]
        return ref.bce(logits[:n], y[:n])

    w0 = inputs.weights(ref.vit_shapes(cfg), r.seed, sig.device)
    return checks.follow(w0, [batch(s) for s in range(steps)], loss_fn, cfg['train'], total,
                         r.seed, sig.device, mode, half)
