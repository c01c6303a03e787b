"""Driver of the long-record MoE cell: the port's ``Trainer`` on Arcee's AFMoE
block (an ``AfmoeConfig``) over 35-minute records, the split resident on the
card, K steps a dispatch (``train.dispatch.Dispatcher``, CUDA graphs), each
step in ``grad_accum`` microbatches of one record.

Set-up makes the split and the weights (on the card, from the seed), builds
the trainer and runs the check's steps through the window's own calls: one
step a dispatch first (it runs eagerly, records each MoE layer's chosen
experts and captures the one-step graph), then one K-step dispatch (it
captures the K-step graph in the same memory pool and replays it).  The
window continues the same batch order, epoch after epoch as
``Trainer.train()`` draws it, with the host read of the metrics after each
dispatch, until the deadline; the MoE layers' held-row counters are read at
its two ends.  Once the window has closed the f32 reference
(``reference/trinity.py``) follows the check's steps from the same weights,
rows and biases, one record at a time.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np
import torch

from .. import checks, inputs, yardstick_attn
from ..reference import model as ref
from ..reference import trinity as tm
from ..trace import Trace
from .train import TRACE_S, TRACE_UNITS, Batches, host_read, train_config
from .train_moe import counters, recorded_choices, route_gap

# AfmoeConfig field <- configuration key
VIT_KEYS = {'max_signal_length': 'max_signal_length', 'patch_size': 'patch_size',
            'num_channels': 'num_channels', 'hidden_size': 'hidden_size',
            'num_hidden_layers': 'num_hidden_layers',
            'num_attention_heads': 'num_attention_heads',
            'num_key_value_heads': 'num_key_value_heads', 'head_dim': 'head_dim',
            'intermediate_size': 'intermediate_size', 'num_class': 'num_class', 'pool': 'pool',
            'patch_norm': 'patch_norm', 'dtype': 'dtype',
            'hidden_dropout_prob': 'hidden_dropout_prob',
            'attention_probs_dropout_prob': 'attention_probs_dropout_prob',
            'sliding_window': 'sliding_window',
            'global_attn_every_n_layers': 'global_attn_every_n_layers',
            'causal': 'causal', 'mup': 'mup_enabled', 'rope_theta': 'rope_theta',
            'rms_norm_eps': 'rms_norm_eps', 'first_k_dense_replace': 'num_dense_layers',
            'moe_num_experts': 'num_experts_published',
            'moe_intermediate_size': 'moe_intermediate_size',
            'moe_top_k': 'num_experts_per_tok', 'moe_routed_scale': 'route_scale',
            'moe_shared_experts': 'num_shared_experts', 'moe_bias_rate': 'load_balance_coeff'}


def vit_config(config: dict):
    """The program's configuration of ``config`` (a program without the
    afmoe block raises here, before any work)."""
    try:
        from ecg_representation_learning_tpu_torch.configs import AfmoeConfig
    except ImportError as e:
        raise SystemExit(f'this checkout of the port has no AFMoE block: {e}') from e
    cfg = AfmoeConfig(moe_held=(config['held_first'], config['num_experts']),
                      moe_seq_aux_weight=0.0, **{k: config[c] for k, c in VIT_KEYS.items()})
    want = [t == 'sliding_attention' for t in config['layer_types'][:cfg.num_hidden_layers]]
    if [cfg.sliding(i) for i in range(cfg.num_hidden_layers)] != want:
        raise ValueError('layer_types is not the period of global_attn_every_n_layers')
    return cfg


def weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 parameters from one normal draw n on ``device``: a matrix and each
    expert's matrix n / sqrt(fan in), a norm scale 1 + 0.02 n, every other
    leaf 0.02 n; then the correction biases, 0."""
    shapes = tm.trinity_shapes(config)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=inputs.generator(seed, inputs._WEIGHTS, device),
                       device=device)
    out, pos = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[pos:pos + n].view(shape)
        pos += n
        if len(shape) >= 2:
            w.mul_(1.0 / math.sqrt(shape[-1]))
        elif name.endswith('.weight'):
            w.mul_(0.02).add_(1.0)
        else:
            w.mul_(0.02)
        out[name] = w
    for name in tm.bias_names(config):
        out[name] = torch.zeros(config['num_experts_published'], device=device)
    return out


def params_only(w: Dict[str, torch.Tensor], config: dict) -> Dict[str, torch.Tensor]:
    biases = set(tm.bias_names(config))
    return {k: v for k, v in w.items() if k not in biases}


def setup(r):
    """The split, the trainer with the seed's weights, and the check's steps
    run through the window's calls.  Returns (state, the program's readings,
    the rows of the check's steps, each MoE layer's chosen experts at step 1)."""
    from ecg_representation_learning_tpu_torch.models.moe import deepseek_layers
    from ecg_representation_learning_tpu_torch.train import SplitData, Trainer
    from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher
    cfg, traffic, dev = r.config, r.traffic, r.device
    k, bsz = traffic['steps_per_dispatch'], traffic['batch_size']
    model_cfg = vit_config(cfg)
    sig, lab = inputs.ptbxl_split(traffic['train_records'], cfg['num_channels'],
                                  traffic['record_samples'], cfg['num_class'], r.seed, dev,
                                  chunk=8)
    data = SplitData(signals=sig, labels=lab)
    tr = Trainer(model_cfg, train_config(cfg, traffic, r.seed, steps_per_dispatch=k,
                                         grad_accum=traffic['grad_accum']),
                 train_data=data, norm_stats=cfg['norm_stats'], output_dir=r.scratch('run'),
                 device=dev)
    tr.set_params(weights(cfg, r.seed, dev))
    gc.collect()
    batches = Batches(len(data), bsz, r.seed)
    disp = Dispatcher(tr, k, scan=False)
    first = batches.take(1)
    with recorded_choices(deepseek_layers(tr.model), traffic['grad_accum']) as rec:
        losses = disp.run(first)[0].tolist()
    chosen = [torch.cat(c) for c in rec]
    grad1 = checks.leaf_norms(tr.opt_state.mu, 1.0 / (1.0 - cfg['train']['b1']))
    second = batches.take(k)
    losses += disp.run(second)[0].tolist()
    w0 = params_only(weights(cfg, r.seed, dev), cfg)
    delta = checks.leaf_norms({n: p.detach() - w0[n] for n, p in tr.model.named_parameters()})
    del w0
    rows = np.concatenate([first, second]).reshape(-1)
    state = {'tr': tr, 'disp': disp, 'data': data, 'batches': batches, 'sig': sig, 'lab': lab}
    return state, {'losses': losses, 'grad1': grad1, 'delta': delta}, rows, chosen


def run(r) -> None:
    cfg, traffic, dev = r.config, r.traffic, r.device
    k, bsz = traffic['steps_per_dispatch'], traffic['batch_size']
    st, prog, rows, chosen = setup(r)
    tr, disp, batches = st['tr'], st['disp'], st['batches']
    idx = torch.as_tensor(rows, device=dev)
    check_sig, check_lab = st['sig'][idx].clone(), st['lab'][idx].clone()

    def unit() -> int:
        """One dispatch of K steps, or of one step where the epoch has fewer
        than K left, with its host read."""
        n = k if batches.left() >= k else 1
        host_read(disp.run(batches.take(n))[2])
        return n

    c0 = counters(tr)
    t0 = r.start_window()
    steps = 0
    while time.perf_counter() - t0 < r.seconds:
        steps += unit()
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    c1 = counters(tr)
    held = c1['held_rows'] - c0['held_rows']
    r.e2e[traffic['metric']] = steps * bsz / wall
    r.window = {'steps': steps, 'samples': steps * bsz, 'seconds': wall,
                'flops_per_sample': yardstick_attn.afmoe_train_flops(cfg, steps * bsz, held)
                / (steps * bsz),
                'params': yardstick_attn.afmoe_param_count(cfg),
                'attn_flops_per_sample': yardstick_attn.afmoe_attention_flops(cfg),
                'moe_held_rows': held, 'moe_busiest_rows': c1['busiest_rows'] - c0['busiest_rows'],
                'moe_held_experts': c1['held_experts'],
                'moe_forwards': steps * tr.cfg.grad_accum * yardstick_attn.afmoe_moe_layers(cfg)}
    r.attempted = steps
    if r.trace:
        c2 = counters(tr)
        # two dispatches at least: the dispatch gap is read only between two
        with Trace(dev) as tr_slice:
            t1, n, dispatches = time.perf_counter(), 0, 0
            while dispatches < 2 or n < TRACE_UNITS or time.perf_counter() - t1 < TRACE_S:
                n += unit()
                dispatches += 1
            tr_slice.units = n
        r.tr = tr_slice
        r.window['trace_samples'] = n * bsz
        r.window['trace_held_rows'] = counters(tr)['held_rows'] - c2['held_rows']
    if dev.type == 'cuda':
        r.memory_peak = torch.cuda.max_memory_allocated(dev)
    total = tr.total_steps
    del st, tr, disp, batches
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    base, ref_chosen = follow(r, check_sig, check_lab, len(prog['losses']), total, 'f32')
    r.checks = checks.judged(numbers(prog, base, chosen, ref_chosen, cfg), r.cell['limits'])


def numbers(prog: dict, base: dict, chosen, ref_chosen, cfg: dict) -> Dict[str, float]:
    """``checks.gaps``, ``loss1_gap`` (the first step's relative loss gap)
    and ``route_gap`` of the first step's routing."""
    out = checks.gaps(prog, base)
    out['loss1_gap'] = abs(prog['losses'][0] - base['losses'][0]) / abs(base['losses'][0])
    out['route_gap'] = route_gap(chosen, ref_chosen, cfg['num_experts_published'])
    return out


def follow(r, sig: torch.Tensor, lab: torch.Tensor, steps: int, total: int, mode: str,
           half: bool = False):
    """The reference's run of the check's ``steps`` steps on ``sig``/``lab``
    (the steps' rows in order), from the seed's weights and zero biases:
    (its readings, each MoE layer's chosen experts at step 1)."""
    cfg = r.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mean = torch.tensor(cfg['norm_stats']['mean'], device=sig.device).reshape(-1, 1)
    std = torch.tensor(cfg['norm_stats']['std'], device=sig.device).reshape(-1, 1)
    bsz = sig.shape[0] // steps
    w = weights(cfg, r.seed, sig.device)
    biases = {k: w.pop(k) for k in tm.bias_names(cfg)}
    p = {k: v.requires_grad_(True) for k, v in w.items()}
    opt = ref.AdamW(p, cfg['train'], total)
    losses, grad1, first = [], None, None
    for s in range(steps):
        # the trainer's transform: an aligned record gains a zero patch, cropped off
        x = checks.time_end_pad((sig[s * bsz:(s + 1) * bsz] - mean) / std,
                                cfg['patch_size'])[..., :cfg['max_signal_length']]
        loss, grads, loads, chosen = tm.batch_grads(p, biases, x, lab[s * bsz:(s + 1) * bsz],
                                                    cfg, mode, r.traffic['reference_chunk'],
                                                    half)
        opt.step(p, grads)
        tm.update_biases(biases, loads, cfg['load_balance_coeff'])
        losses.append(loss)
        if s == 0:
            grad1 = checks.leaf_norms(opt.mu, 1.0 / (1.0 - cfg['train']['b1']))
            first = chosen
        del grads
    w0 = params_only(weights(cfg, r.seed, sig.device), cfg)
    delta = checks.leaf_norms({k: p[k].detach() - w0[k] for k in p})
    return {'losses': losses, 'grad1': grad1, 'delta': delta}, first
