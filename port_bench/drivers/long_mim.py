"""Driver of the long-record pretraining cell: the port's ``RingPretrainer``
(``train/long_record.py``) with ``EcgMim`` on a mesh of one card (one rank on
the sequence axis, so attention runs the flash kernels over the whole
record), the split resident on the card.

Set-up makes the split and the weights (on the card, from the seed), joins a
process group of one rank, builds the pretrainer and runs the check's steps
through the window's own call: ``train_step`` on a batch of the split with
the next mask the pretrainer draws, the loss read on the host, as
``RingPretrainer.train`` runs it.  The window continues the same batch order,
epoch after epoch (each a shuffle of the split), until the deadline.  Once
the window has closed the f32 reference (``reference/mim.py``) follows the
check's steps from the same weights, records and masks.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from .. import checks, inputs, yardstick, yardstick_attn
from ..reference import mim
from ..reference import model as ref
from ..trace import Trace
from .train import TRACE_S, TRACE_UNITS, Batches, train_config

CHECK_STEPS = 3
MIM_KEYS = ('patch_size', 'num_channels', 'hidden_size', 'num_hidden_layers',
            'num_attention_heads', 'intermediate_size', 'patch_norm', 'dtype')


def model_config(config: dict, traffic: dict) -> dict:
    """The configuration's widths at the traffic's record length (its
    ``max_signal_length``)."""
    return {**config, 'max_signal_length': traffic['record_samples']}


def vit_config(cfg: dict):
    from ecg_representation_learning_tpu_torch.configs import VitConfig
    return VitConfig(max_signal_length=cfg['max_signal_length'], ring_axis='data',
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                     **{k: cfg[k] for k in MIM_KEYS})


class Group:
    """A process group of this one rank (NCCL on the card, gloo on the CPU)
    for the pretrainer's mesh; ``close()`` leaves it."""

    def __init__(self, device):
        from ecg_representation_learning_tpu_torch.parallel import init_local_group, make_mesh
        self.store = tempfile.mkdtemp(prefix='port-bench-mim-')
        init_local_group(0, 1, self.store, backend='nccl' if device.type == 'cuda' else 'gloo')
        self.mesh = make_mesh(1, 1, device=device)

    def close(self) -> None:
        import torch.distributed as dist
        dist.destroy_process_group()
        shutil.rmtree(self.store, ignore_errors=True)


def setup(r):
    """The split, the pretrainer with the seed's weights and the check's
    steps.  Returns (state, the program's readings, the check's rows, their
    masks)."""
    from ecg_representation_learning_tpu_torch.train import RingPretrainer
    traffic, dev = r.traffic, r.device
    cfg = r.config = model_config(r.config, traffic)
    bsz = traffic['batch_size']
    sig, _ = inputs.ptbxl_split(traffic['train_records'], cfg['num_channels'],
                                cfg['max_signal_length'], cfg['num_class'], r.seed, dev, chunk=64)
    batches = Batches(len(sig), bsz, r.seed)
    total = batches.steps * traffic['epochs']
    group = Group(dev)
    ring = RingPretrainer(vit_config(cfg), train_config(cfg, traffic, r.seed), group.mesh,
                          mask_ratio=traffic['mask_ratio'], total_steps=total,
                          output_dir=r.scratch('run'))
    ring.init(r.seed)
    w0 = inputs.weights(mim.mim_shapes(cfg), r.seed, dev)
    ring.set_params(w0)
    losses, rows, masks, grad1 = [], [], [], None
    for s in range(CHECK_STEPS):
        take = batches.take(1)[0]
        mask = ring.draw_mask(bsz)
        losses.append(float(ring.train_step(sig[torch.as_tensor(take, device=dev)], mask)))
        rows.append(take)
        masks.append(mask)
        if s == 0:
            grad1 = checks.leaf_norms(ring.opt_state.mu, 1.0 / (1.0 - cfg['train']['b1']))
    delta = checks.leaf_norms({n: p.detach() - w0[n]
                               for n, p in ring.model.named_parameters()})
    state = {'ring': ring, 'group': group, 'sig': sig, 'batches': batches, 'total': total}
    return (state, {'losses': losses, 'grad1': grad1, 'delta': delta}, np.concatenate(rows),
            torch.cat(masks))


def run(r) -> None:
    traffic, dev = r.traffic, r.device
    bsz = traffic['batch_size']
    st, prog, rows, masks = setup(r)
    cfg = r.config
    ring, sig, batches = st['ring'], st['sig'], st['batches']
    check_sig = sig[torch.as_tensor(rows, device=dev)].clone()

    def unit() -> int:
        """One step, its loss read on the host (``RingPretrainer.train``)."""
        take = torch.as_tensor(batches.take(1)[0], device=dev)
        float(ring.train_step(sig[take], ring.draw_mask(bsz)))
        return 1

    try:
        t0 = r.start_window()
        steps = 0
        while time.perf_counter() - t0 < r.seconds:
            steps += unit()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        r.e2e[traffic['metric']] = steps * bsz / wall
        r.window = {'steps': steps, 'samples': steps * bsz, 'seconds': wall,
                    'flops_per_sample': 3.0 * yardstick_attn.mim_forward_flops(cfg),
                    'params': yardstick.param_count(mim.mim_shapes(cfg)),
                    'attn_flops_per_sample': yardstick_attn.mim_attention_flops(cfg)}
        r.attempted = steps
        if r.trace:
            with Trace(dev) as tr_slice:
                t1, n = time.perf_counter(), 0
                while n < TRACE_UNITS or time.perf_counter() - t1 < TRACE_S:
                    n += unit()
                tr_slice.units = n
            r.tr = tr_slice
            r.window['trace_samples'] = n * bsz
        if dev.type == 'cuda':
            r.memory_peak = torch.cuda.max_memory_allocated(dev)
    finally:
        st['group'].close()
    total = st['total']
    del st, ring, sig
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    base = follow(r, check_sig, masks, total, 'f32')
    r.checks = checks.judged(checks.gaps(prog, base), r.cell['limits'])


def follow(r, sig: torch.Tensor, masks: torch.Tensor, total: int, mode: str,
           half: bool = False) -> Dict[str, dict]:
    """The reference's run of the check's steps on ``sig`` (their records in
    order) under ``masks``, from the seed's weights."""
    cfg = r.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bsz = r.traffic['batch_size']
    w0 = inputs.weights(mim.mim_shapes(cfg), r.seed, sig.device)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    opt = ref.AdamW(p, cfg['train'], total)
    losses, grad1 = [], None
    for s in range(sig.shape[0] // bsz):
        part = slice(s * bsz, (s + 1) * bsz)
        loss, grads = mim.batch_grads(p, sig[part], masks[part], cfg, mode, half)
        opt.step(p, grads)
        losses.append(loss)
        if s == 0:
            grad1 = checks.leaf_norms(opt.mu, 1.0 / (1.0 - cfg['train']['b1']))
        del grads
    delta = checks.leaf_norms({k: p[k].detach() - w0[k] for k in p})
    return {'losses': losses, 'grad1': grad1, 'delta': delta}
