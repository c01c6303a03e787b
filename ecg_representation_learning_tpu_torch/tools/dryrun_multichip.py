"""Multi-rank dry run of the mesh trainers: the first four legs of the JAX
package's ``__graft_entry__.dryrun_multichip``, on the port.

    python -m ecg_representation_learning_tpu_torch.tools.dryrun_multichip [--ranks 4]
    torchrun --nproc-per-node 4 -m ecg_representation_learning_tpu_torch.tools.dryrun_multichip

Without ``torchrun`` it starts ``--ranks`` gloo CPU ranks on this host (the
JAX dry run's virtual CPU devices); under ``torchrun`` every rank takes its
card and NCCL.  On N ranks the mesh is (N / 2) x 2 when N >= 4 is even, else
N x 1, with FSDP when the data axis has more than one rank, and a ViT at the
'debug' size with the flash kernels at every sequence length and dropout
on:

1. supervised training (TimeOut on) with an eval pass (macro-AUROC on the
   whole eval split), a checkpoint each epoch, an exact restore into a new
   trainer on the same mesh and its eval loss within 1e-5;
2. MAE pretraining with ``grad_accum=2`` and ``ema_decay=0.9``; the EMA is
   served, and under FSDP Adam's moments are held at the local shard's
   shape (smaller than the Megatron slice);
3. contrastive pretraining, NT-Xent over the global batch;
4. Switch-MoE (4 experts on every second block) with expert parallelism:
   each rank holds 4 / n_model experts.

Rank 0 prints one JSON summary.  Ring context parallelism and the GPipe
pipeline (the JAX dry run's legs 5 and 6) are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import tempfile
from typing import Optional

import torch


def dryrun(out_dir: str, device: Optional[str] = None) -> dict:
    """The four legs on this rank (every rank of the process group calls
    it).  Returns the summary; raises on a failed check."""
    import torch.distributed as dist

    from ..configs import ContrastiveConfig, MaeConfig, TrainConfig, VitConfig
    from ..data import get_ptbxl_splits, synth_ptbxl
    from ..train import Trainer
    from ..train.contrastive import ContrastiveTrainer
    from ..train.pretrain import MaeTrainer

    n = dist.get_world_size()
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_model
    splits = get_ptbxl_splits(*synth_ptbxl(n=96, length=256))
    model_cfg = VitConfig.from_defined('debug', max_signal_length=320, flash_min_seq=0)
    cfg = TrainConfig(num_train_epoch=1, train_batch_size=2 * n_data,
                      eval_batch_size=2 * n_data, mesh_data=n_data, mesh_model=n_model,
                      fsdp=n_data > 1, augment_timeout=True, do_eval=True,
                      save_every_n_epoch=1, log_to_console=False)
    kw = dict(train_data=splits.train, eval_data=splits.eval, device=device)
    out = {'ranks': n, 'mesh': None}

    # 1. train -> eval -> checkpoint -> exact restore -> eval parity
    tr = Trainer(model_cfg, cfg, output_dir=os.path.join(out_dir, 'sup'), **kw)
    out['mesh'] = tr.mesh.shape
    assert tr.mesh.shape == {'data': n_data, 'model': n_model}, tr.mesh.shape
    ev = tr.train()['history'][-1]
    assert math.isfinite(ev['loss']), ev
    assert ev['macro_auc'] is None or 0.0 <= ev['macro_auc'] <= 1.0, ev
    ckpt = tr.latest_checkpoint()
    assert ckpt, 'no checkpoint written under the mesh'
    tr2 = Trainer(model_cfg, cfg, output_dir=os.path.join(out_dir, 'sup'), **kw)
    tr2.load_checkpoint(ckpt)
    ev2 = tr2.evaluate(splits.eval)
    assert abs(ev2['loss'] - ev['loss']) < 1e-5, (ev['loss'], ev2['loss'])
    out['supervised'] = {'eval_loss': ev['loss'], 'restored_eval_loss': ev2['loss'],
                         'macro_auc': ev['macro_auc']}
    del tr, tr2

    # 2. MAE with accumulation and an EMA, on the same mesh
    mae = MaeTrainer(model_cfg, MaeConfig(decoder_num_layers=1),
                     dataclasses.replace(cfg, grad_accum=2, ema_decay=0.9),
                     output_dir=os.path.join(out_dir, 'mae'), **kw)
    res = mae.train()
    assert math.isfinite(res['loss']), res
    assert mae.ema is not None and mae._served_state() is mae.ema
    fc1 = 'encoder_blocks.0.mlp.fc1.weight'
    mu_shape = tuple(mae.opt_state.mu[fc1].shape)
    tp_shape = tuple(mae.sharded.tp_slice(fc1, torch.empty(mae.sharded.full_shapes[fc1])).shape)
    if n_data > 1:   # FSDP: the moments hold the local shard only
        assert math.prod(mu_shape) < math.prod(tp_shape), (mu_shape, tp_shape)
    out['mae'] = {'loss': res['loss'], 'mu_shape': mu_shape, 'megatron_shape': tp_shape}
    del mae

    # 3. contrastive, NT-Xent with the global batch's negatives
    con = ContrastiveTrainer(model_cfg, ContrastiveConfig(proj_hidden_size=32, proj_dim=8),
                             dataclasses.replace(cfg, do_eval=False, save_every_n_epoch=0),
                             output_dir=os.path.join(out_dir, 'con'), **kw)
    res = con.train()
    assert math.isfinite(res['loss']), res
    out['contrastive'] = {'loss': res['loss']}
    del con

    # 4. Switch-MoE with the expert stacks sharded over 'model'
    moe_cfg = dataclasses.replace(model_cfg, moe_num_experts=4, moe_every=2)
    moe = Trainer(moe_cfg, dataclasses.replace(cfg, save_every_n_epoch=0, save_final=False),
                  output_dir=os.path.join(out_dir, 'moe'), **kw)
    ev = moe.train()['history'][-1]
    assert math.isfinite(ev['loss']), ev
    experts = int(moe.sharded.leaves()['encoder.blocks.1.moe.w1'].shape[0])
    assert experts == 4 // n_model, experts
    out['moe'] = {'eval_loss': ev['loss'], 'experts_per_rank': experts}
    return out


def _run(out_dir: str, device: Optional[str]) -> dict:
    return dryrun(out_dir, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--ranks', type=int, default=4,
                    help='gloo CPU ranks to start (ignored under torchrun)')
    ap.add_argument('--out', default=None,
                    help='checkpoint directory, shared by the ranks (default: a temp dir; '
                         'under torchrun runs/dryrun-multichip)')
    args = ap.parse_args(argv)
    ranked = int(os.environ.get('WORLD_SIZE', '1')) > 1   # torchrun: this process is a rank
    out_dir = args.out or ('runs/dryrun-multichip' if ranked
                           else tempfile.mkdtemp(prefix='dryrun-multichip-'))
    try:
        if ranked:
            import torch.distributed as dist

            from ..parallel.distributed import initialize_distributed
            initialize_distributed()
            summary = dryrun(out_dir)
            if dist.get_rank() == 0:
                print(json.dumps(summary), flush=True)
            dist.destroy_process_group()
        else:
            from ..parallel.distributed import spawn_ranks
            print(json.dumps(spawn_ranks(args.ranks, _run, out_dir, 'cpu')[0]), flush=True)
    finally:
        if args.out is None and not ranked:
            shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
