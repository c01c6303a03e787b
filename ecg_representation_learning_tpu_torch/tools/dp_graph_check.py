"""The data-parallel captured dispatch against the eager mesh steps, on N
cards of one host (NCCL, one process a card).

    python -m ecg_representation_learning_tpu_torch.tools.dp_graph_check --ranks 4

Each rank trains a small ViT (hidden 128, 2 layers, dropout on) from the same
weights twice: twelve steps through ``Trainer.train_step`` (eager, DDP), and
four such steps followed by two dispatches of four steps through the
``Dispatcher`` (the first drops the DDP wrapper, runs eagerly through the
tape and captures, the second replays the graph, one flat gradient
all-reduce a step inside).  The batches, seeds and masks are the same; the
gradients' sums over the ranks differ only in their order (DDP's buckets
against one flat buffer).  Rank 0 prints one JSON line: the route, the
replays, and the largest relative gap of a leaf, of the last loss and of
the gradient norm.  The process started by hand is rank 0; it starts the
others.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch


def _rank(rank: int, world: int, device: str) -> None:
    import torch.distributed as dist
    from ..configs import TrainConfig, VitConfig
    from ..parallel.distributed import initialize_distributed
    from ..train import SplitData, Trainer
    from ..train.dispatch import Dispatcher
    initialize_distributed(device=device)
    dev = torch.device('cuda', rank) if device == 'cuda' else torch.device('cpu')
    cfg = VitConfig.from_defined('debug', hidden_size=128, num_hidden_layers=2, dtype='bfloat16',
                                 max_signal_length=640)
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((12 * 16 * world, 12, 600)).astype(np.float32)
    lab = (rng.random((12 * 16 * world, 71)) < 0.3).astype(np.float32)
    data = SplitData(sig, lab)
    bsz = 16 * world
    takes = np.arange(12 * bsz).reshape(12, bsz)
    out = {}
    for route in ('eager', 'graph'):
        tr = Trainer(cfg, TrainConfig(train_batch_size=bsz, num_train_epoch=1, do_eval=False,
                                      save_final=False, log_to_console=False,
                                      steps_per_dispatch=4, seed=11),
                     train_data=data, device=dev,
                     output_dir=os.path.join(tempfile.gettempdir(), 'dp_graph_check', route))
        tr.init_state(11)
        disp = None
        for t in takes if route == 'eager' else takes[:4]:
            m = tr.train_step(data, t)
        print(f'rank {rank}: eager steps done', file=sys.stderr, flush=True)
        if route == 'eager':
            loss, gnorm, info = float(m['loss']), float(m['grad_norm']), {'route': 'eager'}
        else:
            disp = Dispatcher(tr, 4, scan=False)
            for c in (1, 2):
                losses, gnorms, _ = disp.run(takes[4 * c:4 * c + 4])
                print(f'rank {rank}: dispatch {c} ({disp.info()["route"]}) done',
                      file=sys.stderr, flush=True)
            loss, gnorm, info = float(losses[-1]), float(gnorms[-1]), disp.info()
        out[route] = (tr.state_dict(), loss, gnorm, info)
        del tr, disp   # a communicator is destroyed only after the graphs that captured it
        gc.collect()
    if rank == 0:
        (a, la, ga, _), (b, lb, gb, info) = out['eager'], out['graph']
        leaf = max(float((a[k].float() - b[k].float()).norm()
                         / a[k].float().norm().clamp(min=1e-30)) for k in a)
        print(json.dumps({'ranks': world, 'route': info['route'], 'replays': info['replays'],
                          'data_ranks': info.get('data_ranks'), 'leaf_rel_gap': leaf,
                          'loss_rel_gap': abs(la - lb) / abs(la),
                          'grad_norm_rel_gap': abs(ga - gb) / abs(ga)}), flush=True)
    if device == 'cuda':
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--ranks', type=int, default=4)
    p.add_argument('--rank', type=int, default=None)
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='cpu: gloo ranks, the eager tape on both routes (a rehearsal)')
    a = p.parse_args(argv)
    if a.rank is not None:
        _rank(a.rank, int(os.environ['WORLD_SIZE']), a.device)
        return 0
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    env = {**os.environ, 'MASTER_ADDR': 'localhost', 'MASTER_PORT': str(port),
           'WORLD_SIZE': str(a.ranks)}
    procs = [subprocess.Popen([sys.executable, '-m', __spec__.name, '--rank', str(i),
                               '--device', a.device],
                              env={**env, 'RANK': str(i), 'LOCAL_RANK': str(i)})
             for i in range(1, a.ranks)]
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port), WORLD_SIZE=str(a.ranks),
                      RANK='0', LOCAL_RANK='0')
    _rank(0, a.ranks, a.device)
    return max([p.wait(timeout=600) for p in procs] + [0])


if __name__ == '__main__':
    sys.exit(main())
