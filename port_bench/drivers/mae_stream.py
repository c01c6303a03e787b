"""Driver of the streaming MAE cells: the port's ``MaeTrainer.train_stream``
over ``prefetch_to_device(MixedRecordStream(...))``, the shards int16
``.npy`` files of the seed's records under the run's temporary directory.

Set-up writes the shards, builds the trainer with the seed's weights, warms
each corpus's preprocessing (``ops.preprocess.fused_train_path`` on one batch
of zeros: its filter designs and tap tables), and runs the check's three
steps as three calls of ``train_stream`` of one step each.  The window is one
more call, fed by the harness's iterator, which ends at the deadline and
times how long each batch took to come.  The reference follows the three
steps: it draws the stream's batches from the same shard files in the
stream's documented order (a seeded weighted choice of corpus; per corpus a
seeded shuffle of its shards, then of each shard's records), decodes them,
resamples and low-passes them with SciPy in float64, z-normalizes, pads and
crops them, and trains.
"""
from __future__ import annotations

import gc
import shutil
import time

import numpy as np
import torch

from .. import checks, inputs, yardstick
from ..reference import model as ref
from ..trace import Trace
from .train import train_config, vit_config

TRACE_S = 1.5
CHECK_STEPS = 3


class Feed:
    """The batch iterator handed to ``train_stream``: stops at ``deadline``
    and sums the time each ``next`` took (the step waiting for its input)."""

    def __init__(self, it):
        self.it, self.deadline = it, None
        self.wait_s, self.items = 0.0, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise StopIteration
        t = time.perf_counter()
        item = next(self.it)
        self.wait_s += time.perf_counter() - t
        self.items += 1
        return item


def mae_config(cfg: dict):
    from ecg_representation_learning_tpu_torch.configs import MaeConfig
    return MaeConfig(mask_ratio=cfg['mask_ratio'], decoder_hidden_size=cfg['decoder_hidden_size'],
                     decoder_num_layers=cfg['decoder_num_layers'],
                     decoder_num_heads=cfg['decoder_num_heads'],
                     decoder_intermediate_size=cfg['decoder_intermediate_size'],
                     norm_patch_targets=cfg['norm_patch_targets'])


def setup(r):
    """The shards, the trainer with the seed's weights, the preprocessing
    warmed, and the check's steps.  Returns (state, the program's readings,
    the shard paths)."""
    from ecg_representation_learning_tpu_torch.data.pipeline import (
        MixedRecordStream, ShardedRecordStream, prefetch_to_device)
    from ecg_representation_learning_tpu_torch.ops.preprocess import fused_train_path
    from ecg_representation_learning_tpu_torch.train import MaeTrainer

    class NpyShards(ShardedRecordStream):
        def _load_shard(self, path):
            arr = np.load(path)
            return arr if self.dtype is None else arr.astype(self.dtype)

    class NpyMix(MixedRecordStream):
        stream_cls = NpyShards

    cfg, traffic, dev = r.config, r.traffic, r.device
    bsz, corpora = traffic['batch_size'], traffic['corpora']
    leads, scale = cfg['num_channels'], float(traffic['wire_scale'])
    paths = inputs.write_shards(r.scratch('shards'), corpora, leads, scale, r.seed, dev)
    shapes = ref.mae_shapes(cfg)
    w0 = inputs.weights(shapes, r.seed, dev)
    tr = MaeTrainer(vit_config(cfg), mae_config(cfg),
                    train_config(cfg, {'epochs': traffic['stream_steps'], 'batch_size': bsz},
                                 r.seed),
                    norm_stats=cfg['norm_stats'], output_dir=r.scratch('run'), device=dev)
    tr.set_params(w0)
    mean = torch.tensor(cfg['norm_stats']['mean'], device=dev)
    std = torch.tensor(cfg['norm_stats']['std'], device=dev)
    for c in corpora:
        fused_train_path(torch.zeros((bsz, leads, c['samples']), device=dev), mean, std,
                         fqs=c['fqs'], target_fqs=250, patch_size=cfg['patch_size'])
    stream = NpyMix(paths, batch_size=bsz, weights=[c['weight'] for c in corpora],
                    seed=r.seed, dtype=None)
    feed = Feed(prefetch_to_device(iter(stream), depth=traffic['prefetch_depth'], device=dev))
    kw = dict(raw_fqs=[c['fqs'] for c in corpora], wire_scale=[scale] * len(corpora),
              log_every=traffic['log_every'])

    losses = []
    for s in range(CHECK_STEPS):
        losses.append(tr.train_stream(feed, total_steps=1, **kw)['loss'])
        if s == 0:
            grad1 = checks.leaf_norms(tr.opt_state.mu, 1.0 / (1.0 - cfg['train']['b1']))
    delta = checks.leaf_norms({n: p.detach() - w0[n] for n, p in tr.model.named_parameters()})
    prog = {'losses': losses, 'grad1': grad1, 'delta': delta}
    return {'tr': tr, 'feed': feed, 'kw': kw, 'shapes': shapes}, prog, paths


def run(r) -> None:
    cfg, traffic, dev = r.config, r.traffic, r.device
    bsz = traffic['batch_size']
    st, prog, paths = setup(r)
    tr, feed, kw = st['tr'], st['feed'], st['kw']
    feed.wait_s = 0.0
    t0 = r.start_window()
    feed.deadline = t0 + r.seconds
    steps = tr.train_stream(feed, total_steps=traffic['stream_steps'] - CHECK_STEPS,
                            **kw)['steps']
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    r.e2e['pretrain_samples_per_s'] = steps * bsz / wall
    r.window = {'steps': steps, 'samples': steps * bsz, 'seconds': wall,
                'input_wait_s': feed.wait_s,
                'flops_per_sample': yardstick.train_flops_per_sample(cfg),
                'params': yardstick.param_count(st['shapes'])}
    r.attempted = steps
    if r.trace:
        with Trace(dev) as tr_slice:
            feed.deadline = time.perf_counter() + TRACE_S
            tr_slice.units = tr.train_stream(feed, total_steps=traffic['stream_steps'],
                                             **kw)['steps']
        r.tr = tr_slice
    if dev.type == 'cuda':
        r.memory_peak = torch.cuda.max_memory_allocated(dev)
    total = tr.total_steps
    del st, feed, tr
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    base = follow(r, paths, total, 'f32')
    r.checks = checks.judged(checks.gaps(prog, base), r.cell['limits'])
    shutil.rmtree(r.scratch('shards'))


def stream_order(paths, weights, bsz: int, seed: int, steps: int):
    """The first ``steps`` batches of the weighted mixture: (corpus, shard
    path, record rows) each.  A seeded choice of corpus per batch; per
    corpus (seed + 1000 (i + 1)) a shuffle of its shards each pass, and of a
    shard's records when the stream reaches it, cut into full batches."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    mix = np.random.default_rng(seed)
    gens = []

    def batches(i):
        rng = np.random.default_rng(seed + 1000 * (i + 1))
        while True:
            for si in rng.permutation(len(paths[i])):
                n = np.load(paths[i][si], mmap_mode='r').shape[0]
                idx = rng.permutation(n)
                for lo in range(0, (n // bsz) * bsz, bsz):
                    yield paths[i][si], idx[lo:lo + bsz]

    gens = [batches(i) for i in range(len(paths))]
    out = []
    for _ in range(steps):
        i = int(mix.choice(len(paths), p=w))
        out.append((i, *next(gens[i])))
    return out


def follow(r, paths, total: int, mode: str, half: bool = False) -> dict:
    """The reference's run of the check's steps."""
    from ..reference.preprocess import model_input
    cfg, traffic, dev = r.config, r.traffic, r.device
    corpora = traffic['corpora']
    order = stream_order(paths, [c['weight'] for c in corpora], traffic['batch_size'], r.seed,
                         CHECK_STEPS)

    def batch(i, path, rows):
        def make():
            x = model_input(np.load(path)[rows], corpora[i]['fqs'], float(traffic['wire_scale']),
                            cfg['norm_stats'], cfg['patch_size'], cfg['max_signal_length'])
            return torch.as_tensor(x, dtype=torch.float32, device=dev), None
        return make

    def loss_fn(p, x, y, draws, mode, half):
        return ref.mae_loss(p, x, cfg, draws, mode, half)

    w0 = inputs.weights(ref.mae_shapes(cfg), r.seed, dev)
    return checks.follow(w0, [batch(*o) for o in order], loss_fn, cfg['train'], total, r.seed,
                         dev, mode, half)
