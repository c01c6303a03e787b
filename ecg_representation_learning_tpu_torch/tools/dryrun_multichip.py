"""Multi-rank dry run of the parallel trainers: the six legs of the JAX
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
   each rank holds 4 / n_model experts;
5. ring context parallelism: ``RingPretrainer`` with the sequence split
   over all N ranks ('debug', 4 leads, patch 64, 128 N samples, dropout
   off), two steps with finite losses;
6. the GPipe pipeline: ``PipelineVitTrainer`` ('debug' with
   ``scan_blocks``, dropout on, 320 samples, bs 16) on (N / S) x S ranks
   with S = min(4, N): a finite loss, each rank holding only its stage's
   layers and their Adam moments, and the merged parameters driving the
   one-device ``EcgVit``.

Rank 0 prints one JSON summary.
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

import numpy as np
import torch


def dryrun(out_dir: str, device: Optional[str] = None) -> dict:
    """The six legs on this rank (every rank of the process group calls
    it).  Returns the summary; raises on a failed check."""
    import torch.distributed as dist

    from ..configs import ContrastiveConfig, MaeConfig, TrainConfig, VitConfig
    from ..data import get_ptbxl_splits, synth_ptbxl
    from ..models.vit import EcgVit
    from ..parallel import make_mesh
    from ..train import PipelineVitTrainer, RingPretrainer, Trainer
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
    del moe

    # 5. ring context parallelism: the sequence split over all n ranks
    cp_cfg = VitConfig.from_defined('debug', max_signal_length=128 * n, patch_size=64,
                                    num_channels=4, use_flash_attention=False, ring_axis='data',
                                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ring = RingPretrainer(cp_cfg, TrainConfig(learning_rate=1e-3), make_mesh(n, 1, device=device),
                          seq_axis='data', total_steps=2)
    rng = np.random.default_rng(0)
    res = ring.train((rng.standard_normal((2, 4, cp_cfg.max_signal_length)).astype(np.float32)
                      for _ in range(2)), steps=2)
    assert len(res['losses']) == 2 and all(math.isfinite(v) for v in res['losses']), res
    out['ring'] = {'shards': n, 'losses': res['losses']}
    del ring

    # 6. the GPipe pipeline on (n / S) x S ranks, dropout on
    n_stage = min(4, n)
    n_pp_data = max(1, n // n_stage)
    pp_cfg = VitConfig.from_defined('debug', max_signal_length=320, scan_blocks=True)
    pp = PipelineVitTrainer(pp_cfg, dataclasses.replace(
        cfg, num_train_epoch=1, mesh_model=1, mesh_data=n_pp_data, mesh_stage=n_stage,
        fsdp=False, train_batch_size=16), train_data=splits.train,
        output_dir=os.path.join(out_dir, 'pp'), device=device)
    res = pp.train()
    assert math.isfinite(res['loss']), res
    # stage leaves and their Adam moments: this stage's layers only
    qkv = 'encoder.blocks.attn.qkv.weight'
    per = pp_cfg.num_hidden_layers // n_stage
    local, mu = tuple(pp.model.get_parameter(qkv).shape), tuple(pp.opt_state.mu[qkv].shape)
    assert local == mu and local[0] == per, (local, mu)
    # the merged parameters drive the one-device model
    model = EcgVit(pp_cfg).eval()
    model.load_state_dict(pp.merged_params())
    with torch.no_grad():
        logits = model(torch.zeros(2, 12, 320)).logits
    assert bool(torch.isfinite(logits).all())
    out['pipeline'] = {'mesh': {'data': n_pp_data, 'stage': n_stage}, 'loss': res['loss'],
                       'stage_qkv_shape': local, 'layers_per_stage': per}
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
