"""Every parallelism mode of the PyTorch port (the twin of
``examples/parallel_training.py``), on one process group.

Run:
  python examples/torch/parallel_training.py --platform cpu [--ranks 8]
      (starts N gloo CPU ranks here, as ``cli --platform cpu --host-devices N``
      does, in place of the JAX example's 8 virtual CPU devices)
  torchrun --nproc-per-node 8 examples/torch/parallel_training.py
      (one card per rank over NCCL)

Modes demonstrated, on N ranks:
  1. DP x TP (+FSDP): Megatron tensor parallelism over 'model' (2 ranks),
     the batch over 'data' (N / 2), ZeRO-style storage sharding of params and
     Adam moments (TrainConfig.mesh_data / mesh_model / fsdp)
  2. Pipeline parallelism: EcgVit's block stack staged over 'stage'
     (S = 4 when N >= 8, else 2; TrainConfig.mesh_stage; train/pipeline_vit.py)
  3. Context parallelism: masked-signal pretraining with the SEQUENCE split
     over all N ranks (ring attention; train/long_record.py)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np


def data_parallel_tensor_parallel(splits, device=None) -> dict:
    """Mode 1 on every rank: a (N / 2) x 2 mesh with FSDP."""
    import torch.distributed as dist
    from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
    from ecg_representation_learning_tpu_torch.train import Trainer
    n = dist.get_world_size()
    model_cfg = VitConfig.from_defined('debug', max_signal_length=320)
    cfg = TrainConfig(num_train_epoch=1, train_batch_size=8, eval_batch_size=8,
                      mesh_data=n // 2, mesh_model=2, fsdp=True, save_final=False,
                      log_to_console=False)
    tr = Trainer(model_cfg, cfg, train_data=splits.train, eval_data=splits.eval,
                 output_dir='runs/ex-dp-tp', device=device)
    res = tr.train()
    qkv = tuple(tr._leaves()['encoder.blocks.0.attn.qkv.weight'].shape)
    print_rank0(f"1. DP({n // 2}) x TP(2) + FSDP: eval loss {res['history'][-1]['loss']:.4f}; "
                f'local qkv shard {qkv} on mesh {dict(tr.mesh.shape)}')
    return {'eval_loss': res['history'][-1]['loss'], 'qkv_shard': qkv, 'mesh': tr.mesh.shape}


def pipeline_parallel(splits, device=None) -> dict:
    """Mode 2 on every rank: the GPipe pipeline on (N / S) x S ranks."""
    import torch.distributed as dist
    from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
    from ecg_representation_learning_tpu_torch.train import PipelineVitTrainer
    n = dist.get_world_size()
    n_stage = 4 if n >= 8 else 2
    pp_model = VitConfig.from_defined('debug', max_signal_length=320,
                                      scan_blocks=True)   # stacked layout
    pp_cfg = TrainConfig(num_train_epoch=1, train_batch_size=16, mesh_data=n // n_stage,
                         mesh_stage=n_stage, do_eval=False, save_final=False,
                         log_to_console=False)
    pp = PipelineVitTrainer(pp_model, pp_cfg, train_data=splits.train,
                            output_dir='runs/ex-pp', device=device)
    res = pp.train()
    stage_qkv = tuple(pp.model.get_parameter('encoder.blocks.attn.qkv.weight').shape)
    print_rank0(f"2. DP({n // n_stage}) x PP({n_stage}): loss {res['loss']:.4f}; "
                f'stage params {stage_qkv} (layers of this stage)')
    return {'loss': res['loss'], 'stage_qkv': stage_qkv, 'stages': n_stage}


def context_parallel(device=None) -> dict:
    """Mode 3 on every rank: ``RingPretrainer`` with the sequence split over
    all ranks."""
    import torch.distributed as dist
    from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
    from ecg_representation_learning_tpu_torch.parallel import make_mesh
    from ecg_representation_learning_tpu_torch.train import RingPretrainer
    n = dist.get_world_size()
    cp_model = VitConfig.from_defined(
        'debug', max_signal_length=128 * n, patch_size=64, num_channels=4,
        use_flash_attention=False, ring_axis='data',
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    ring = RingPretrainer(cp_model, TrainConfig(learning_rate=1e-3),
                          make_mesh(n_data=n, n_model=1, device=device), seq_axis='data',
                          total_steps=4, output_dir='runs/ex-ring')
    rng = np.random.default_rng(0)
    stream = (rng.standard_normal((2, 4, cp_model.max_signal_length)).astype(np.float32)
              for _ in range(4))
    res = ring.train(stream, steps=4)
    print_rank0(f"3. ring CP over {n} sequence shards: losses "
                f"{[round(v, 3) for v in res['losses']]}")
    return {'losses': res['losses'], 'shards': n}


def print_rank0(msg: str) -> None:
    import torch.distributed as dist
    if dist.get_rank() == 0:
        print(msg, flush=True)


def run(device=None) -> dict:
    """The three modes on this rank (every rank of the group calls it)."""
    from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits, synth_ptbxl
    splits = get_ptbxl_splits(*synth_ptbxl(n=128, length=256))
    return {'dp_tp': data_parallel_tensor_parallel(splits, device),
            'pipeline': pipeline_parallel(splits, device),
            'ring': context_parallel(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--platform', default=None, choices=['cuda', 'cpu'],
                    help='cpu: start --ranks gloo CPU ranks here; default: this process '
                         'is one rank of a torchrun launch, on its card')
    ap.add_argument('--ranks', type=int, default=8,
                    help='with --platform cpu: the number of gloo ranks (even, >= 4)')
    args = ap.parse_args(argv)
    if args.platform == 'cpu':
        from ecg_representation_learning_tpu_torch.parallel.distributed import spawn_ranks
        if args.ranks < 4 or args.ranks % 2:
            raise SystemExit('--ranks must be even and at least 4')
        return spawn_ranks(args.ranks, run, 'cpu')[0]
    from ecg_representation_learning_tpu_torch.parallel.distributed import (
        initialize_distributed)
    initialize_distributed(device=args.platform)
    return run()


if __name__ == '__main__':
    main()
