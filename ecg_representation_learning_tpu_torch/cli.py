"""Command-line interface of the port.

    python -m ecg_representation_learning_tpu_torch.cli synth --n 512 --out data/
    python -m ecg_representation_learning_tpu_torch.cli train --size base --epochs 3 \
        --hdf5 data/PTB-XL-combined.hdf5 --labels-csv data/ptb-xl-labels.csv
    python -m ecg_representation_learning_tpu_torch.cli pretrain --objective contrastive
    python -m ecg_representation_learning_tpu_torch.cli train --init-encoder \
        runs/contrastive/ckpt-final --probe
    python -m ecg_representation_learning_tpu_torch.cli evaluate --checkpoint runs/x/ckpt-final \
        --hdf5 ... --labels-csv ... --pick-edge-samples
    python -m ecg_representation_learning_tpu_torch.cli infer --hdf5 unlabeled.hdf5 --int8
    python -m ecg_representation_learning_tpu_torch.cli serve --checkpoint runs/x/ckpt-final
    python -m ecg_representation_learning_tpu_torch.cli port --port-checkpoint ep8.pt
    python -m ecg_representation_learning_tpu_torch.cli denoise --input ptbxl-combined.hdf5
    python -m ecg_representation_learning_tpu_torch.cli export --dataset PTB-XL \
        --data-root raw/ --out data/
    python -m ecg_representation_learning_tpu_torch.cli export-shards --dataset PTB-XL \
        --data-root raw/ --out shards/ptbxl
    python -m ecg_representation_learning_tpu_torch.cli pretrain --stream shards/ptbxl \
        --stream shards/code-test --stream-weights 0.75,0.25 --stream-steps 1000 \
        --ckpt-every 100 [--resume]
    python -m ecg_representation_learning_tpu_torch.cli export-model --checkpoint \
        runs/x/ckpt-final [--int8] [--platforms cuda,cpu] --out exported_model
    python -m ecg_representation_learning_tpu_torch.cli tokenize --hdf5 x-combined.hdf5 --k 8
    python -m ecg_representation_learning_tpu_torch.cli visualize --checkpoint \
        runs/x/ckpt-final --split test --index 0

``train``, ``pretrain`` and ``evaluate`` read a combined HDF5 and its label
index (``--hdf5``, ``--labels-csv``; ``cli synth`` writes both), else they
run on the synthetic PTB-XL-shaped corpus (``synth_ptbxl(n=--synth-n)``), as
the JAX CLI does.  ``infer`` scores an unlabeled combined HDF5 (top-k codes
per record to JSON); ``--port-checkpoint`` starts ``train``, ``evaluate``,
``serve`` and ``infer`` from a reference vit-pytorch 0.33.2 ``.pt``, and
``port`` converts one into the port's checkpoint format once.  ``--int8``
serves weight-only int8 Linear weights (and MoE expert stacks).
``--moe-experts E --moe-every k`` (train, pretrain with or without
``--stream``, evaluate, infer, serve, port) makes every k-th block a
Switch-MoE block with E experts.  The flags are the JAX CLI's, with
its names and defaults, for the features the port has; ``--checkpoint``,
``--resume-from`` and ``--init-encoder`` take the port's checkpoints
(``train/checkpoint.py``).  ``denoise`` is the JAX CLI's (combined HDF5 ->
denoised HDF5, resumable).

Ingest: ``export`` reads raw corpora (WFDB trees, Chapman CSVs, the
CODE-test bulk HDF5) into ``{key}-combined.hdf5`` on the 250 Hz grid (FFT
resample on the GPU) plus ``records.csv``; ``export-shards`` writes one
corpus as native-rate int16 shards; ``pretrain --stream DIR ...`` (repeat
per corpus) runs streaming MAE pretraining over them -- a weighted mixture,
each corpus preprocessed on the GPU at its own rate (shard metadata), with
``--ckpt-every`` checkpoints and an exact ``--resume``.  ``--objective
contrastive`` is refused with ``--stream``, as in the JAX CLI.  The HDF5
paths need h5py; everything runs on the GPU, and ``denoise --device cpu``
runs the plain versions of the kernels on the CPU.

Meshes: ``train`` and ``pretrain`` take ``--mesh-model M`` (Megatron tensor
parallelism and expert parallelism over M ranks; the data axis takes the
rest) and ``--fsdp`` (ZeRO storage sharding over the data axis), on every
rank of the process group: on cards under ``torchrun --nproc-per-node N``
(NCCL, one card per rank), on the CPU with ``--platform cpu --host-devices
N`` (N gloo ranks started here; the JAX CLI's N virtual CPU devices).
``train --mesh-stage S`` trains the GPipe pipeline instead (the block stack
over S stages, the data axis the ranks left; ``--port-checkpoint``,
``--init-encoder`` and ``--resume-from`` apply, and the merged parameters
are evaluated on one device; it prints ``train_loss``, ``test_macro_auc``
and ``mesh``).  Rank 0 writes the checkpoints and prints the result.

    torchrun --nproc-per-node 4 -m ecg_representation_learning_tpu_torch.cli train \
        --mesh-model 2 --fsdp
    python -m ecg_representation_learning_tpu_torch.cli --platform cpu --host-devices 4 \
        train --size debug --mesh-model 2 --fsdp
    python -m ecg_representation_learning_tpu_torch.cli --platform cpu --host-devices 4 \
        train --size debug --mesh-stage 2

Tools: ``export-model`` writes the served model as a ``torch.export``
artifact (``models/export_artifact.py``: ``model.pt2`` + ``metadata.json``;
``ExportedModel.load`` runs it with only the port's op module imported);
``tokenize`` fits the segment tokenizer (``models/tokenizer.py``) and pickles
it; ``visualize`` renders the attention rollout of one record on the served
weights (matplotlib and seaborn, imported when used).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_common_train_flags(p):
    p.add_argument('--size', default='base',
                   choices=['debug', 'tiny', 'small', 'base', 'large'])
    p.add_argument('--epochs', type=int, default=3)
    p.add_argument('--batch-size', type=int, default=64)
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--weight-decay', type=float, default=1e-2)
    p.add_argument('--schedule', default='cosine', choices=['cosine', 'constant'])
    p.add_argument('--warmup-ratio', type=float, default=0.05)
    p.add_argument('--patience', type=int, default=8)
    p.add_argument('--timeout-augment', action='store_true')
    p.add_argument('--mesh-model', type=int, default=1,
                   help='tensor-parallel axis size (data axis = ranks / this)')
    p.add_argument('--fsdp', action='store_true',
                   help='ZeRO-style storage sharding of params + Adam moments '
                        'over the data axis')
    p.add_argument('--resident-dtype', default=None,
                   choices=[None, 'float16', 'bfloat16'],
                   help='storage dtype of the device-resident signals (halves '
                        'their bytes; steps compute in float32)')
    p.add_argument('--grad-accum', type=int, default=1,
                   help='microbatches per optimizer step (activation memory '
                        '/ N at the same effective batch; grads averaged '
                        'before one update)')
    p.add_argument('--ema-decay', type=float, default=0.0,
                   help='>0: keep an EMA of the params (e.g. 0.999); '
                        'eval/inference then run on the EMA weights')
    p.add_argument('--moe-experts', type=int, default=0,
                   help="Switch-MoE: replace every --moe-every-th block's MLP with this "
                        'many expert FFNs behind a top-1 router (models/moe.py)')
    p.add_argument('--moe-every', type=int, default=2)
    p.add_argument('--seed', type=int, default=77)
    p.add_argument('--output-dir', default=None)
    p.add_argument('--n-sample', type=int, default=None)
    p.add_argument('--bf16', action=argparse.BooleanOptionalAction, default=True,
                   help='bfloat16 Linear layers (--no-bf16 for float32)')
    p.add_argument('--patch-norm', action=argparse.BooleanOptionalAction,
                   default=True,
                   help='LayerNorms around the patch projection (--no-patch-norm: '
                        'the reference vit-pytorch 0.33.2 layout, which '
                        '--port-checkpoint implies)')


def _add_stats_flag(p):
    p.add_argument('--stats', default=None, choices=[None, 'original', 'denoised'],
                   help='PTB-XL per-lead normalization statistics')


def _model_cfg_for(args):
    """VitConfig for the run; --port-checkpoint implies the reference
    vit-pytorch-0.33.2 layout (patch_norm=False); --moe-experts E makes every
    --moe-every-th block a Switch-MoE block."""
    from .configs import VitConfig
    from .models.port import reference_vit_config
    from .utils.check_args import ca
    ca(model_size=args.size)
    dtype = 'bfloat16' if args.bf16 else 'float32'
    if getattr(args, 'port_checkpoint', None) or not args.patch_norm:
        cfg = reference_vit_config(args.size, dtype=dtype)
    else:
        cfg = VitConfig.from_defined(args.size, dtype=dtype)
    if args.moe_experts:
        cfg = dataclasses.replace(cfg, moe_num_experts=args.moe_experts,
                                  moe_every=args.moe_every)
    return cfg


def _load_splits(args):
    from .data import get_ptbxl_splits, load_ptbxl_from_export, synth_ptbxl
    if args.hdf5 and args.labels_csv:
        return load_ptbxl_from_export(args.hdf5, args.labels_csv, args.n_sample)
    print('[cli] no --hdf5/--labels-csv given; using a synthetic PTB-XL-shaped corpus',
          file=sys.stderr)
    signals, labels, folds = synth_ptbxl(n=args.synth_n)
    return get_ptbxl_splits(signals, labels, folds, args.n_sample)


def _stats(args):
    from .registry import PTBXL_TRAIN_STATS
    return PTBXL_TRAIN_STATS[args.stats] if args.stats else None


def _load_ckpt(tr, args):
    """Restore --checkpoint; say so when its EMA weights are not served."""
    tr.load_checkpoint(args.checkpoint)
    if tr.last_restore_info.get('dropped_ema'):
        print(f'[hint] {args.checkpoint} contains EMA weights but --ema-decay was '
              f'not given: serving the RAW params. Pass --ema-decay (e.g. the '
              f'training value) to serve the EMA weights instead.', file=sys.stderr)


def _maybe_port(args, tr):
    """Install the reference vit-pytorch state_dict of --port-checkpoint."""
    if getattr(args, 'port_checkpoint', None):
        from .models.port import port_vit_pytorch_state_dict, read_reference_state_dict
        tr.set_params(port_vit_pytorch_state_dict(
            read_reference_state_dict(args.port_checkpoint), tr.model_cfg))


def _serving_trainer(args):
    """The inference trainer of ``serve`` and ``infer``: seeded init, then
    --port-checkpoint, --checkpoint and --int8 in that order."""
    from .configs import TrainConfig
    from .train import Trainer
    tr = Trainer(_model_cfg_for(args), TrainConfig(eval_batch_size=args.batch_size,
                                                   ema_decay=args.ema_decay),
                 norm_stats=_stats(args), device=args.device)
    tr.init_state()
    _maybe_port(args, tr)
    if args.checkpoint:
        _load_ckpt(tr, args)
    if args.int8:
        tr.enable_int8_inference()
    return tr


def cmd_train(args):
    from .configs import TrainConfig
    from .train import Trainer
    splits = _load_splits(args)
    cfg = TrainConfig(
        num_train_epoch=args.epochs, train_batch_size=args.batch_size,
        eval_batch_size=args.batch_size, learning_rate=args.lr,
        weight_decay=args.weight_decay, schedule=args.schedule,
        warmup_ratio=args.warmup_ratio, patience=args.patience,
        augment_timeout=args.timeout_augment, seed=args.seed, n_sample=args.n_sample,
        resident_dtype=args.resident_dtype, grad_accum=args.grad_accum,
        ema_decay=args.ema_decay, linear_probe=args.probe, mesh_model=args.mesh_model,
        fsdp=args.fsdp, mesh_stage=args.mesh_stage, epoch_scan=args.epoch_scan,
        steps_per_dispatch=args.steps_per_dispatch)
    if cfg.mesh_stage > 1:
        return _train_pipeline(args, cfg, splits)
    tr = Trainer(_model_cfg_for(args), cfg, train_data=splits.train,
                 eval_data=splits.eval, norm_stats=_stats(args),
                 output_dir=args.output_dir, device=args.device)
    _maybe_port(args, tr)
    if args.init_encoder:
        # the SSL -> supervised handoff: a pretrained trunk (MAE or
        # contrastive, detected) into the classifier; --probe freezes it
        from .train.contrastive import load_any_encoder
        tr.init_state()
        tr.set_params(load_any_encoder(args.init_encoder, tr.state_dict()))
    if args.resume_from:
        tr.load_checkpoint(args.resume_from)
    result = tr.train()
    test_metrics = tr.evaluate(splits.test)
    _result({'best_eval_loss': result['best_eval_loss'],
             'test_macro_auc': test_metrics['macro_auc'],
             'epochs': result['epochs']})


def _train_pipeline(args, cfg, splits):
    """``train --mesh-stage S``: the block stack staged over S ranks of every
    data group (``train/pipeline_vit.py``; n_data = ranks / S), then the
    merged parameters evaluated on one device."""
    import torch.distributed as dist

    from .configs import TrainConfig
    from .models.vit import stack_unrolled_state_dict, unstack_scanned_state_dict
    from .train import Trainer
    from .train.pipeline_vit import PipelineVitTrainer
    model_cfg = dataclasses.replace(_model_cfg_for(args), scan_blocks=True)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_data = world // cfg.mesh_stage
    pp = PipelineVitTrainer(model_cfg, dataclasses.replace(cfg, mesh_data=n_data),
                            train_data=splits.train, norm_stats=_stats(args),
                            output_dir=args.output_dir, device=args.device)
    layers = model_cfg.num_hidden_layers
    pp.init_state()
    if getattr(args, 'port_checkpoint', None):
        # the reference .pt -> the unrolled layout -> stacked -> staged
        from .models.port import port_vit_pytorch_state_dict, read_reference_state_dict
        ported = port_vit_pytorch_state_dict(read_reference_state_dict(args.port_checkpoint),
                                             dataclasses.replace(model_cfg, scan_blocks=False))
        pp.set_merged_params(stack_unrolled_state_dict(ported, layers))
    if args.init_encoder:
        # an SSL trunk (MAE or contrastive, detected) into the unrolled view
        from .train.contrastive import load_any_encoder
        unrolled = unstack_scanned_state_dict(pp.merged_params(), layers)
        pp.set_merged_params(stack_unrolled_state_dict(
            load_any_encoder(args.init_encoder, unrolled), layers))
    if args.resume_from:
        pp.load_checkpoint(args.resume_from)
    result = pp.train()
    ev = Trainer(model_cfg, TrainConfig(eval_batch_size=args.batch_size, log_to_console=False),
                 norm_stats=_stats(args), output_dir=args.output_dir, device=pp.device,
                 mesh=False)
    ev.init_state()
    ev.set_params(pp.merged_params())
    test_metrics = ev.evaluate(splits.test)
    _result({'train_loss': result['loss'], 'test_macro_auc': test_metrics['macro_auc'],
             'mesh': f'{n_data} data x {cfg.mesh_stage} stage'})


def _expand_corpus(spec: str):
    """One ``--stream`` value -> sorted shard paths: a directory (all *.hdf5
    inside), a glob, or a single shard file."""
    import glob as globlib
    if os.path.isdir(spec):
        paths = sorted(globlib.glob(os.path.join(spec, '*.hdf5')))
    elif any(ch in spec for ch in '*?['):
        paths = sorted(globlib.glob(spec))
    else:
        paths = [spec]
    if not paths:
        raise SystemExit(f'--stream {spec}: no shard files found')
    return paths


def _cmd_pretrain_stream(args):
    """BASELINE config 5 as a product path: streaming multi-corpus MAE
    pretraining over shard directories (``cli export-shards`` output), with
    per-corpus weighted mixing, per-corpus native-rate preprocessing on the
    GPU, int16 wire decode, periodic checkpoints and an exact resume."""
    from .configs import MaeConfig, TrainConfig
    from .data.export import read_shard_meta
    from .data.pipeline import MixedRecordStream, prefetch_to_device
    from .train.pretrain import MaeTrainer
    if getattr(args, 'objective', 'mae') != 'mae':
        raise SystemExit('--stream supports --objective mae (the config-5 '
                         'pretrain job); contrastive streaming is not a '
                         'reference capability')
    corpora = [_expand_corpus(s) for s in args.stream]
    metas = [read_shard_meta(c[0]) for c in corpora]
    # per-corpus native rate + wire scale: shard metadata by default
    # (written by `cli export-shards`), flags override for plain shards
    if args.stream_raw_fqs:
        raw_fqs = [int(v) for v in args.stream_raw_fqs.split(',')]
    else:
        raw_fqs = [m.get('fqs', 250) for m in metas]
    if args.stream_wire_scale:
        wire_scale = [(None if v in ('', 'none') else float(v))
                      for v in args.stream_wire_scale.split(',')]
    else:
        wire_scale = [m.get('wire_scale') for m in metas]
    weights = ([float(v) for v in args.stream_weights.split(',')]
               if args.stream_weights else None)
    for name, seq in (('--stream-raw-fqs', raw_fqs),
                      ('--stream-wire-scale', wire_scale),
                      ('--stream-weights', weights or raw_fqs)):
        if len(seq) != len(corpora):
            raise SystemExit(f'{name}: {len(seq)} values for {len(corpora)} corpora')
    # train_data=None makes steps_per_epoch 1, so the LR schedule spans
    # exactly --stream-steps optimizer steps
    cfg = TrainConfig(
        num_train_epoch=args.stream_steps, train_batch_size=args.batch_size,
        eval_batch_size=args.batch_size, learning_rate=args.lr,
        weight_decay=args.weight_decay, schedule=args.schedule,
        warmup_ratio=args.warmup_ratio, grad_accum=args.grad_accum,
        ema_decay=args.ema_decay, seed=args.seed, mesh_model=args.mesh_model,
        fsdp=args.fsdp)
    tr = MaeTrainer(_model_cfg_for(args), MaeConfig(mask_ratio=args.mask_ratio), cfg,
                    norm_stats=_stats(args), output_dir=args.output_dir or 'runs/mae-stream',
                    device=args.device)
    stream = MixedRecordStream(corpora, batch_size=args.batch_size, weights=weights,
                               seed=args.seed, dtype=None)
    # on a mesh each rank moves its rows of every batch only
    res = tr.train_stream(
        prefetch_to_device(iter(stream), depth=2, device=tr.device, sharding=tr.mesh),
        total_steps=args.stream_steps, raw_fqs=raw_fqs, wire_scale=wire_scale,
        log_every=args.log_every, ckpt_every=args.ckpt_every,
        resume=args.resume_from or args.resume, local_batches=tr.mesh is not None)
    ckpt = tr.latest_checkpoint() or tr.save_checkpoint(tag='final')
    _result({'pretrain_loss': res['loss'], 'steps': res['steps'],
             'mix_counts': res['mix_counts'], 'corpora': [len(c) for c in corpora],
             'checkpoint': ckpt})


def cmd_pretrain(args):
    from .configs import ContrastiveConfig, MaeConfig, TrainConfig
    from .train.contrastive import ContrastiveTrainer
    from .train.pretrain import MaeTrainer
    if args.stream:
        return _cmd_pretrain_stream(args)
    splits = _load_splits(args)
    cfg = TrainConfig(
        num_train_epoch=args.epochs, train_batch_size=args.batch_size,
        eval_batch_size=args.batch_size, learning_rate=args.lr,
        weight_decay=args.weight_decay, schedule=args.schedule,
        warmup_ratio=args.warmup_ratio, patience=args.patience,
        resident_dtype=args.resident_dtype, grad_accum=args.grad_accum,
        ema_decay=args.ema_decay, seed=args.seed, mesh_model=args.mesh_model, fsdp=args.fsdp)
    kw = dict(train_data=splits.train, eval_data=splits.eval, norm_stats=_stats(args),
              device=args.device)
    if args.objective == 'contrastive':
        tr = ContrastiveTrainer(_model_cfg_for(args),
                                ContrastiveConfig(temperature=args.temperature), cfg,
                                output_dir=args.output_dir or 'runs/contrastive', **kw)
    else:
        tr = MaeTrainer(_model_cfg_for(args), MaeConfig(mask_ratio=args.mask_ratio), cfg,
                        output_dir=args.output_dir or 'runs/mae', **kw)
    result = tr.train(resume=args.resume_from or False)
    _result({'pretrain_loss': result['loss'], 'best_eval_loss': result['best_eval_loss'],
             'checkpoint': result['checkpoint']})


def cmd_evaluate(args):
    from .configs import TrainConfig
    from .train import Trainer
    from .train.evaluate import evaluate_trained
    splits = _load_splits(args)
    tr = Trainer(_model_cfg_for(args), TrainConfig(ema_decay=args.ema_decay,
                                                   eval_batch_size=args.batch_size),
                 eval_data=splits.eval, norm_stats=_stats(args), device=args.device)
    tr.init_state()
    _maybe_port(args, tr)
    if args.checkpoint:
        _load_ckpt(tr, args)
    named = {'eval': splits.eval, 'test': splits.test}
    results = evaluate_trained(tr, named, out_dir=args.out)
    if args.pick_edge_samples:
        from .train.evaluate import pick_eval_eg
        pick_eval_eg(tr, named, out_dir=args.out)
    print(json.dumps({k: v.get('macro_auc') for k, v in results.items()
                      if isinstance(v, dict)}))


def cmd_visualize(args):
    """Render an attention-rollout figure for one record (reference
    EcgVitVisualizer workflow, ecg_vit.py:164-265), from the served weights
    (the EMA with --ema-decay)."""
    import matplotlib
    matplotlib.use('Agg')
    import numpy as np
    from .configs import TrainConfig
    from .train import Trainer
    from .utils import EcgVitVisualizer
    splits = _load_splits(args)
    model_cfg = _model_cfg_for(args)
    tr = Trainer(model_cfg, TrainConfig(ema_decay=args.ema_decay), eval_data=splits.eval,
                 norm_stats=_stats(args), device=args.device)
    tr.init_state()
    if args.checkpoint:
        _load_ckpt(tr, args)
    data = {'eval': splits.eval, 'test': splits.test}[args.split]
    sig = np.asarray(data.signals[args.index], np.float32)
    # the normalize + always-pad the model expects, then its input length
    mean = tr.mean.cpu().numpy().reshape(-1, 1)
    std = tr.std.cpu().numpy().reshape(-1, 1)
    sig = (sig - mean) / std
    n_pad = model_cfg.patch_size - (sig.shape[-1] % model_cfg.patch_size)
    sig = np.pad(sig, [(0, 0), (0, n_pad)])[:, :model_cfg.max_signal_length]
    path = EcgVitVisualizer(tr.served_model())(sig, data.labels[args.index], save=True)
    print(json.dumps({'figure': path}))


def infer_records(tr, signals, top_k: int = 5):
    """Per-record top-k PTB-XL codes of ``signals`` (N, 12, L) through
    ``tr.predict_long`` (records longer than the model input are windowed,
    per-class max): ``{'n_records', 'top_k', 'records': [{'record': i,
    'top': [{'code', 'prob'}, ...]}, ...]}``, records numbered in input
    order."""
    import numpy as np
    from .registry import PTBXL_ID2CODE
    probs = tr.predict_long(signals)
    top = np.argsort(-probs, axis=1)[:, :top_k]
    records = [{'record': int(i),
                'top': [{'code': PTBXL_ID2CODE[int(c)], 'prob': float(probs[i, c])}
                        for c in top[i]]}
               for i in range(probs.shape[0])]
    return {'n_records': len(records), 'top_k': top_k, 'records': records}


def cmd_infer(args):
    """Batch inference on an unlabeled combined HDF5: per-record top-k codes
    to JSON (the serving-side counterpart of ``evaluate``).  Records are
    numbered as ``EcgDataset.load()`` returns them: the processed rows of a
    partially denoised file."""
    from .data import EcgDataset
    ds = EcgDataset(args.hdf5)
    try:
        signals = ds.load()
    finally:
        ds.close()
    result = infer_records(_serving_trainer(args), signals, args.top_k)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f)
    print(json.dumps({'out': args.out, 'n_records': result['n_records']}))


def cmd_serve(args):
    """Run the batch-inference HTTP server on the GPU (serving.py)."""
    from .serving import serve
    tr = _serving_trainer(args)
    httpd = serve(tr, host=args.host, port=args.port)
    print(json.dumps({'serving': f'http://{args.host}:{httpd.server_address[1]}',
                      'endpoints': ['/health', '/predict']}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        httpd.service.close()


def cmd_export_model(args):
    """Export the served model as a ``torch.export`` serving artifact
    (models/export_artifact.py): normalization + pad + forward + sigmoid in
    one program, weights inside, symbolic batch."""
    from .configs import TrainConfig
    from .models.export_artifact import export_model
    from .train import Trainer
    tr = Trainer(_model_cfg_for(args), TrainConfig(ema_decay=args.ema_decay),
                 norm_stats=_stats(args), device=args.device)
    tr.init_state()
    _maybe_port(args, tr)
    if args.checkpoint:
        _load_ckpt(tr, args)
    platforms = args.platforms.split(',') if args.platforms else None
    meta = export_model(tr, args.out, signal_length=args.signal_length,
                        int8=args.int8, platforms=platforms)
    print(json.dumps({'out': args.out, 'bytes': meta['bytes'],
                      'platforms': meta['platforms'],
                      'signal_length': meta['wire']['signal_length'],
                      'int8': meta['int8']}))


def cmd_tokenize(args):
    """Fit the segment tokenizer (models/tokenizer.py) on a combined HDF5 or
    the synthetic corpus and pickle it."""
    from .models.tokenizer import EcgTokenizer
    from .utils.check_args import ca
    ca(pad_mode=args.pad)
    if args.hdf5:
        from .data import EcgDataset
        ds = EcgDataset(args.hdf5)
        try:
            sigs = ds.load()
        finally:
            ds.close()
    else:
        from .data import synth_ptbxl
        sigs, _, _ = synth_ptbxl(n=args.synth_n)
    tok = EcgTokenizer(k=args.k, pad=args.pad).fit(
        sigs, n_clusters=args.clusters, n_iter=args.iters, seed=args.seed)
    path = tok.save(args.out)
    rf = tok.rank_frequency()
    print(json.dumps({'tokenizer': path, 'n_clusters': int(tok.centers.shape[0]),
                      'power_law_exponent': rf['exponent']}))


def cmd_port(args):
    """One-time conversion: a reference vit-pytorch EcgVit state_dict (.pt)
    -> the port's checkpoint ``{out}/ckpt-ported`` (``--checkpoint`` and
    ``--resume-from`` take it)."""
    from .configs import TrainConfig
    from .train import Trainer
    tr = Trainer(_model_cfg_for(args), TrainConfig(), output_dir=args.out, device=args.device)
    tr.init_state()
    _maybe_port(args, tr)
    path = tr.save_checkpoint(tag='ported')
    print(json.dumps({'checkpoint': path, 'size': args.size,
                      'note': 'load with a patch_norm=False config '
                              '(models.port.reference_vit_config)'}))


def cmd_synth(args):
    """Write a synthetic PTB-XL-shaped corpus: ``PTB-XL-combined.hdf5`` and
    ``ptb-xl-labels.csv`` under --out."""
    from .data import synth_ptbxl, write_combined_hdf5, write_labels_csv
    signals, labels, folds = synth_ptbxl(n=args.n, seed=args.seed,
                                         n_marker_classes=args.marker_classes,
                                         hard=args.hard)
    h5 = write_combined_hdf5(os.path.join(args.out, 'PTB-XL-combined.hdf5'), signals)
    labels_csv = write_labels_csv(os.path.join(args.out, 'ptb-xl-labels.csv'), labels, folds)
    print(json.dumps({'hdf5': h5, 'labels_csv': labels_csv, 'n': args.n}))


def cmd_export(args):
    """Raw corpora -> ``{key}-combined.hdf5`` each (every corpus of
    ``EXPORT_DATASETS`` unless --dataset) and ``records.csv`` under --out."""
    from .data.export import export_combined, export_records_csv
    from .registry import EXPORT_DATASETS
    keys = [args.dataset] if args.dataset else list(EXPORT_DATASETS)
    for key in keys:
        export_combined(key, args.data_root, args.out)
    export_records_csv(keys, args.data_root, os.path.join(args.out, 'records.csv'))


def cmd_export_shards(args):
    from .data.export import export_shards
    paths = export_shards(args.dataset, args.data_root, args.out,
                          records_per_shard=args.records_per_shard,
                          wire_dtype=args.wire, wire_scale=args.wire_scale)
    print(json.dumps({'shards': len(paths), 'out': args.out, 'first': paths[0]}))


def cmd_denoise(args):
    from .configs import PreprocessConfig
    from .data.export import export_denoised
    cfg = PreprocessConfig(nlm_search_width=args.nlm_search_width,
                           loess_robust_iters=args.loess_robust_iters)
    out = export_denoised(args.input, args.out, cfg=cfg, batch=args.batch,
                          resume=not args.no_resume, device=args.device)
    print(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog='ecg-torch')
    p.add_argument('--platform', default=None, choices=['cuda', 'cpu'],
                   help='run the trainers on this device (default: the GPU); cpu runs '
                        'the plain versions of the kernels')
    p.add_argument('--host-devices', type=int, default=None,
                   help='with --platform cpu: start this many gloo CPU ranks on this '
                        'host (multi-rank runs of --mesh-model / --fsdp / --mesh-stage)')
    sub = p.add_subparsers(dest='cmd', required=True)
    for name, fn in (('train', cmd_train), ('pretrain', cmd_pretrain),
                     ('evaluate', cmd_evaluate), ('visualize', cmd_visualize)):
        sp = sub.add_parser(name)
        _add_common_train_flags(sp)
        sp.add_argument('--hdf5', default=None)
        sp.add_argument('--labels-csv', default=None)
        sp.add_argument('--synth-n', type=int, default=512)
        _add_stats_flag(sp)
        if name in ('train', 'evaluate'):
            sp.add_argument('--port-checkpoint', default=None, metavar='PT_FILE',
                            help='initialize from a reference vit-pytorch EcgVit '
                                 'state_dict (.pt) via models/port.py')
        if name in ('train', 'pretrain'):
            sp.add_argument('--resume-from', default=None)
        if name == 'train':
            sp.add_argument('--epoch-scan', action='store_true',
                            help='run each epoch as ONE jitted lax.scan dispatch over '
                                 'the train step (device-resident splits; removes '
                                 'per-step host dispatch -- bit-identical updates)')
            sp.add_argument('--steps-per-dispatch', type=int, default=1,
                            help='unroll K train steps into one jitted dispatch '
                                 '(amortizes per-dispatch runtime overhead on '
                                 'high-latency-attached hosts; program size grows ~K-fold)')
            sp.add_argument('--mesh-stage', type=int, default=1,
                            help='pipeline-parallel stage count (>1 stages the transformer '
                                 'stack over a stage mesh axis; GPipe microbatches; the '
                                 'data axis takes the ranks left)')
            sp.add_argument('--init-encoder', default=None, metavar='SSL_CKPT',
                            help='initialize the encoder trunk from a pretrain '
                                 'checkpoint (cli pretrain output; MAE or '
                                 'contrastive, detected)')
            sp.add_argument('--probe', action='store_true',
                            help='linear probe: freeze the pretrained trunk, '
                                 'train only the classification head')
        if name == 'pretrain':
            sp.add_argument('--objective', default='mae', choices=['mae', 'contrastive'],
                            help='self-supervised objective: masked-patch '
                                 'reconstruction (MAE) or two-view NT-Xent')
            sp.add_argument('--mask-ratio', type=float, default=0.75)
            sp.add_argument('--temperature', type=float, default=0.1,
                            help='NT-Xent temperature (contrastive only)')
            sp.add_argument('--stream', action='append', default=None, metavar='SHARDS',
                            help='streaming multi-corpus pretrain (BASELINE config 5): '
                                 'repeat once per corpus; each value is a shard '
                                 'directory, glob, or file (cli export-shards output). '
                                 'Batches mix across corpora by --stream-weights; each '
                                 'corpus is preprocessed on the GPU at its own native '
                                 'rate (shard metadata)')
            sp.add_argument('--stream-steps', type=int, default=1000,
                            help='total optimizer steps of the streaming job '
                                 '(the LR schedule spans exactly this)')
            sp.add_argument('--stream-weights', default=None,
                            help='comma-separated per-corpus mixing weights '
                                 '(default: uniform)')
            sp.add_argument('--stream-raw-fqs', default=None,
                            help='comma-separated per-corpus native sampling '
                                 'rates; default: read from shard metadata')
            sp.add_argument('--stream-wire-scale', default=None,
                            help="comma-separated per-corpus int16 wire scales "
                                 "('none' = float shards); default: shard metadata")
            sp.add_argument('--ckpt-every', type=int, default=0,
                            help='save a step-tagged checkpoint every N stream steps '
                                 '(exact resume)')
            sp.add_argument('--resume', action='store_true',
                            help='resume the streaming job from the newest committed '
                                 'checkpoint under --output-dir (bit-identical to an '
                                 'uninterrupted run over the deterministic stream)')
            sp.add_argument('--log-every', type=int, default=50)
        if name in ('evaluate', 'visualize'):
            sp.add_argument('--checkpoint', default=None)
        if name == 'evaluate':
            sp.add_argument('--out', default='eval')
            sp.add_argument('--pick-edge-samples', action='store_true',
                            help='also dump low/median/high-loss sample indices')
        if name == 'visualize':
            sp.add_argument('--split', default='test', choices=['eval', 'test'])
            sp.add_argument('--index', type=int, default=0)
        sp.set_defaults(fn=fn)
    pi = sub.add_parser('infer', help='unlabeled HDF5 -> per-record top-k '
                                      'code probabilities (JSON)')
    _add_common_train_flags(pi)
    pi.add_argument('--hdf5', required=True)
    _add_stats_flag(pi)
    pi.add_argument('--checkpoint', default=None)
    pi.add_argument('--port-checkpoint', default=None, metavar='PT_FILE')
    pi.add_argument('--top-k', type=int, default=5)
    pi.add_argument('--int8', action='store_true',
                    help='weight-only int8 quantized inference (models/quantize.py; '
                         '~4x smaller weights)')
    pi.add_argument('--out', default='predictions.json')
    pi.set_defaults(fn=cmd_infer)
    psv = sub.add_parser('serve', help='HTTP batch-inference server '
                                       '(GET /health, POST /predict)')
    _add_common_train_flags(psv)
    _add_stats_flag(psv)
    psv.add_argument('--checkpoint', default=None,
                     help='a port checkpoint (ckpt-* directory) to serve; '
                          'default: a seeded random init')
    psv.add_argument('--port-checkpoint', default=None, metavar='PT_FILE')
    psv.add_argument('--int8', action='store_true',
                     help='serve weight-only int8 quantized weights')
    psv.add_argument('--host', default='127.0.0.1')
    psv.add_argument('--port', type=int, default=8000)
    psv.set_defaults(fn=cmd_serve)
    pem = sub.add_parser('export-model',
                         help='trained checkpoint -> self-contained torch.export serving '
                              'artifact (weights inside; loads with only the '
                              "port's op module imported)")
    _add_common_train_flags(pem)
    _add_stats_flag(pem)
    pem.add_argument('--checkpoint', default=None)
    pem.add_argument('--port-checkpoint', default=None, metavar='PT_FILE')
    pem.add_argument('--int8', action='store_true',
                     help='store weight-only int8 tensors with the dequantization in '
                          'the program (~4x smaller artifact)')
    pem.add_argument('--signal-length', type=int, default=None,
                     help='wire length L of requests (default: model input minus one '
                          'patch)')
    pem.add_argument('--platforms', default=None,
                     help="comma-separated devices to check the program on and allow "
                          "at load, e.g. 'cuda,cpu' (default: this machine's GPU)")
    pem.add_argument('--out', default='exported_model')
    pem.set_defaults(fn=cmd_export_model)
    pt = sub.add_parser('tokenize')
    pt.add_argument('--hdf5', default=None)
    pt.add_argument('--synth-n', type=int, default=128)
    pt.add_argument('--k', type=int, default=8)
    pt.add_argument('--pad', default='shift', choices=['zero', 'shift'])
    pt.add_argument('--clusters', type=int, default=256)
    pt.add_argument('--iters', type=int, default=64)
    pt.add_argument('--seed', type=int, default=77)
    pt.add_argument('--out', default='tokenizer.pickle')
    pt.set_defaults(fn=cmd_tokenize)
    pp = sub.add_parser('port', help='reference vit-pytorch EcgVit .pt -> a port '
                                     'checkpoint')
    _add_common_train_flags(pp)
    pp.add_argument('--port-checkpoint', required=True, metavar='PT_FILE')
    pp.add_argument('--out', default='ported')
    pp.set_defaults(fn=cmd_port)
    ps = sub.add_parser('synth', help='write a synthetic PTB-XL-shaped corpus')
    ps.add_argument('--n', type=int, default=512)
    ps.add_argument('--seed', type=int, default=77)
    ps.add_argument('--marker-classes', type=int, default=0,
                    help='>0: mark that many classes with frequency-band '
                         'markers (multi-class quality benchmark)')
    ps.add_argument('--hard', action='store_true',
                    help='discriminating variant: overlapping bands, noisy '
                         'amplitudes, confounders, long-tailed prevalence')
    ps.add_argument('--out', default='data')
    ps.set_defaults(fn=cmd_synth)
    pe = sub.add_parser('export', help='raw corpora -> unified 250 Hz HDF5')
    pe.add_argument('--dataset', default=None)
    pe.add_argument('--data-root', required=True)
    pe.add_argument('--out', required=True)
    pe.set_defaults(fn=cmd_export)
    pes = sub.add_parser('export-shards', help='raw corpus -> native-rate int16 pretrain '
                                               'shards (cli pretrain --stream input)')
    pes.add_argument('--dataset', required=True)
    pes.add_argument('--data-root', required=True)
    pes.add_argument('--out', required=True)
    pes.add_argument('--records-per-shard', type=int, default=256)
    pes.add_argument('--wire', default='int16', choices=['int16', 'float32'],
                     help='shard storage dtype (int16 counts halve the host -> GPU '
                          'wire; decoded on the GPU)')
    pes.add_argument('--wire-scale', type=float, default=1000.0,
                     help='counts per physical unit for int16 shards')
    pes.set_defaults(fn=cmd_export_shards)
    pd_ = sub.add_parser('denoise', help='combined HDF5 -> denoised HDF5')
    pd_.add_argument('--input', required=True)
    pd_.add_argument('--out', default=None)
    pd_.add_argument('--batch', type=int, default=64)
    pd_.add_argument('--nlm-search-width', type=int, default=None)
    pd_.add_argument('--loess-robust-iters', type=int, default=5,
                     help='bisquare iterations (5 = MATLAB-exact; 2 stays '
                          'within the reference export tolerance)')
    pd_.add_argument('--no-resume', action='store_true')
    pd_.add_argument('--device', default=None, choices=['cuda', 'cpu'],
                     help='default: the GPU; cpu runs the plain versions of '
                          'the kernels')
    pd_.set_defaults(fn=cmd_denoise)
    return p


def _result(obj) -> None:
    """Print a command's JSON result (on a mesh, rank 0 alone)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(obj), flush=True)


def _rank_main(argv):
    """One CPU rank of ``--platform cpu --host-devices N``."""
    args = build_parser().parse_args(argv)
    args.device = 'cpu'
    args.fn(args)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if getattr(args, 'device', None) is None:   # denoise has a --device of its own
        args.device = args.platform
    if args.host_devices and args.host_devices > 1:
        if args.platform != 'cpu':
            raise SystemExit('--host-devices N starts N CPU ranks: add --platform cpu '
                             '(on cards run under torchrun)')
        from .parallel.distributed import spawn_ranks
        spawn_ranks(args.host_devices, _rank_main, argv)
        return
    from .parallel.distributed import initialize_distributed
    initialize_distributed(device=args.platform)   # a no-op for one process
    args.fn(args)


if __name__ == '__main__':
    main()
