"""Driver of the data-parallel supervised cell: the port's ``Trainer`` on a
mesh of ``chips`` ranks over 'data' (one process a card, NCCL; gloo on the
CPU), the split resident on every card, K steps a dispatch as one CUDA graph
a rank with each step's gradient all-reduce inside (``Dispatcher``'s flat
gradient sync).

The harness's process is rank 0.  It starts ranks 1.. as processes of this
module (``python -m port_bench.drivers.train_dp --rank i ...``) with the
variables ``parallel/distributed.py`` reads (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), and every rank
runs the same set-up as the one-card cell (``drivers/train.py``: the split
and weights from the seed, the check's steps through the window's calls, at
the global batch).  The window starts at a barrier, continues while rank 0
says so (one flag a dispatch, broadcast over a gloo group on the host, so
every rank runs the same steps) and ends at a barrier after the device
work; rank 0 reports every rank's samples over it.  A traced run profiles
rank 0's slice.  Once the ranks have left, rank 0 runs the f32 reference of
the check's steps at the global batch, each data rank's rows with that
rank's dropout draws, as the mesh draws them: a generator a data rank seeded
with ``SeedSequence([seed, rank])``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from .. import checks, inputs, yardstick
from ..reference import model as ref
from ..trace import Trace
from . import train

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JOIN_S = 600.0          # how long rank 0 waits for the other ranks to end


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run(r) -> None:
    """Rank 0 (the harness's process): start the other ranks, run, judge."""
    world = r.chips
    env = {'MASTER_ADDR': 'localhost', 'MASTER_PORT': str(_free_port()),
           'WORLD_SIZE': str(world)}
    args = ['--workload', r.workload, '--seed', str(r.seed), '--seconds', str(r.seconds),
            '--trace', str(int(r.trace)), '--device', r.device.type,
            '--overrides', json.dumps(r.overrides)]
    procs = [subprocess.Popen([sys.executable, '-m', 'port_bench.drivers.train_dp',
                               '--rank', str(i), *args], cwd=ROOT,
                              env={**os.environ, **env, 'RANK': str(i), 'LOCAL_RANK': str(i)})
             for i in range(1, world)]
    os.environ.update(env, RANK='0', LOCAL_RANK='0')
    try:
        out = rank_main(r, 0, world)
    finally:
        deadline = time.perf_counter() + JOIN_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                p.kill()
    if any(p.returncode for p in procs):
        raise RuntimeError(f'a rank failed: exit codes {[p.returncode for p in procs]}')
    prog, rows, total = out
    idx = torch.as_tensor(rows, device=r.device)
    sig, lab = inputs.ptbxl_split(r.traffic['train_records'], r.config['num_channels'],
                                  r.config['record_samples'], r.config['num_class'], r.seed,
                                  r.device)
    sig, lab = sig[idx].clone(), lab[idx].clone()
    gc.collect()
    base = follow(r, sig, lab, len(prog['losses']), total, 'f32', world)
    r.checks = checks.judged(checks.gaps(prog, base), r.cell['limits'])


def rank_main(r, rank: int, world: int):
    """Every rank's part: the process group, set-up, the window, the traced
    slice.  Rank 0 returns (the program's readings, the check's rows, the
    schedule's total steps); the others None."""
    import torch.distributed as dist
    from ecg_representation_learning_tpu_torch.parallel.distributed import (
        initialize_distributed)
    initialize_distributed(device=r.device.type)
    ctl = dist.new_group(backend='gloo')     # the window's flags and counts, on the host
    traffic = r.traffic
    k, bsz = traffic['steps_per_dispatch'], traffic['batch_size']
    st, prog, rows = train.setup(r)
    tr, disp, data, batches = st['tr'], st['disp'], st['data'], st['batches']
    if r.device.type == 'cuda' and disp.info()['route'] != 'graph':
        raise SystemExit('the cell measures the captured data-parallel dispatch; this '
                         f'program dispatches by the {disp.info()["route"]!r} route')

    def unit() -> int:
        n = k if batches.left() >= k else 1
        train.host_read(disp.run(batches.take(n))[2])
        return n

    def go_on(stop: bool) -> bool:
        """Rank 0's ``stop`` on every rank."""
        flag = torch.tensor([int(stop)])
        dist.broadcast(flag, 0, group=ctl)
        return not bool(flag.item())

    dist.barrier(group=ctl)
    t0 = r.start_window() if rank == 0 else time.perf_counter()
    steps = 0
    while True:
        steps += unit()
        if not go_on(time.perf_counter() - t0 >= r.seconds):
            break
    if r.device.type == 'cuda':
        torch.cuda.synchronize(r.device)
    dist.barrier(group=ctl)
    wall = time.perf_counter() - t0
    local = torch.tensor([steps * (bsz // world)])
    samples = [torch.zeros_like(local) for _ in range(world)]
    dist.all_gather(samples, local, group=ctl)
    total_samples = int(sum(int(s) for s in samples))
    r.e2e[traffic['metric']] = total_samples / wall
    # matmul FLOPs a sample over the ranks' cards: the share of a card's peak
    r.window = {'steps': steps, 'samples': total_samples, 'seconds': wall,
                'flops_per_sample': yardstick.train_flops_per_sample(r.config) / world,
                'params': yardstick.param_count(ref.vit_shapes(r.config)),
                'ranks': world}
    r.attempted = steps
    if r.trace:
        tr_slice = Trace(r.device).start() if rank == 0 else None
        t1, n = time.perf_counter(), 0
        while True:
            n += unit()
            if not go_on(n >= train.TRACE_UNITS and time.perf_counter() - t1 >= train.TRACE_S):
                break
        if tr_slice is not None:
            tr_slice.stop()
            tr_slice.units = n
            r.tr = tr_slice
    if r.device.type == 'cuda':
        r.memory_peak = torch.cuda.max_memory_allocated(r.device)
    total = tr.total_steps
    # the graphs go first: a communicator they captured is destroyed after them
    del st, tr, disp, data, batches
    gc.collect()
    if r.device.type == 'cuda':
        torch.cuda.synchronize(r.device)
        torch.cuda.empty_cache()
    dist.barrier(group=ctl)
    dist.destroy_process_group()
    return (prog, rows, total) if rank == 0 else None


class RankDraws(ref.Draws):
    """The dropout draws of one data rank of the mesh: one generator on
    ``device`` seeded with ``SeedSequence([seed, rank])``'s first 64 bits
    shifted right by 2."""

    def __init__(self, seed: int, rank: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(np.random.SeedSequence([int(seed), rank]).generate_state(
            1, np.uint64)[0] >> 2))


def follow(r, sig: torch.Tensor, lab: torch.Tensor, steps: int, total: int, mode: str,
           ranks: int, half: bool = False, exchange: bool = True) -> dict:
    """The reference's run of the check's ``steps`` steps at the global batch
    (``sig``/``lab``, the steps' rows in order): each step's loss the mean
    over the data ranks of each rank's loss on its contiguous rows, drawn
    from that rank's generator.  Planted faults: ``half`` leaves the second
    half of each rank's rows out of the loss; ``exchange`` False leaves the
    gradient exchange out, so rank 0 steps on its own rows' loss alone."""
    cfg = r.config
    mean = torch.tensor(cfg['norm_stats']['mean'], device=sig.device).reshape(-1, 1)
    std = torch.tensor(cfg['norm_stats']['std'], device=sig.device).reshape(-1, 1)
    bsz = sig.shape[0] // steps
    per = bsz // ranks
    draws = [RankDraws(r.seed, j, sig.device) for j in range(ranks)]

    def batch(s):
        def make():
            x = (sig[s * bsz:(s + 1) * bsz] - mean) / std
            return checks.time_end_pad(x, cfg['patch_size']), lab[s * bsz:(s + 1) * bsz]
        return make

    def loss_fn(p, x, y, _draws, mode, half):
        n = per // 2 if half else per
        out, used = 0.0, ranks if exchange else 1
        for j in range(used):
            logits = ref.vit_logits(p, x[j * per:(j + 1) * per], cfg, draws[j], mode)
            out = out + ref.bce(logits[:n], y[j * per:j * per + n])
        return out / used

    w0 = inputs.weights(ref.vit_shapes(cfg), r.seed, sig.device)
    return checks.follow(w0, [batch(s) for s in range(steps)], loss_fn, cfg['train'], total,
                         r.seed, sig.device, mode, half)


def main(argv=None) -> int:
    """A rank other than 0: the same cell's run in this process."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--rank', type=int, required=True)
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, default=0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--overrides', default='{}')
    a = p.parse_args(argv)
    from .. import harness
    entry, cell, config, traffic = harness.resolve(a.workload)
    over = json.loads(a.overrides)
    dev = torch.device('cuda', a.rank) if a.device == 'cuda' else torch.device('cpu')
    r = harness.Run(workload=a.workload, seed=a.seed, seconds=a.seconds, trace=bool(a.trace),
                    device=dev, t_process=time.perf_counter(), cell=cell,
                    config={**config, **over.get('config', {})},
                    traffic={**traffic, **over.get('traffic', {})}, chips=entry['chips'],
                    overrides=over)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    rank_main(r, a.rank, int(os.environ['WORLD_SIZE']))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)     # done: nothing of this rank's is left to tear down


if __name__ == '__main__':
    sys.exit(main())
