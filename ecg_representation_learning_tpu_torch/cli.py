"""Command-line interface of the port.

    python -m ecg_representation_learning_tpu_torch.cli train --size base --epochs 3
    python -m ecg_representation_learning_tpu_torch.cli evaluate --checkpoint runs/x/ckpt-final
    python -m ecg_representation_learning_tpu_torch.cli serve --checkpoint runs/x/ckpt-final

``train`` and ``evaluate`` run on the synthetic PTB-XL-shaped corpus
(``synth_ptbxl(n=--synth-n)``, as the JAX CLI does without ``--hdf5``; the
HDF5 loaders are not ported).  The flags are the JAX CLI's, with its names
and defaults, for the features the port has; ``--checkpoint`` and
``--resume-from`` take the port's checkpoints (``train/checkpoint.py``).
Everything runs on the GPU.
"""
from __future__ import annotations

import argparse
import json
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
    p.add_argument('--grad-accum', type=int, default=1,
                   help='microbatches per optimizer step (activation memory '
                        '/ N at the same effective batch; grads averaged '
                        'before one update)')
    p.add_argument('--ema-decay', type=float, default=0.0,
                   help='>0: keep an EMA of the params (e.g. 0.999); '
                        'eval/inference then run on the EMA weights')
    p.add_argument('--seed', type=int, default=77)
    p.add_argument('--output-dir', default=None)
    p.add_argument('--bf16', action=argparse.BooleanOptionalAction, default=True,
                   help='bfloat16 Linear layers (--no-bf16 for float32)')
    p.add_argument('--patch-norm', action=argparse.BooleanOptionalAction,
                   default=True,
                   help='LayerNorms around the patch projection (--no-patch-norm: '
                        'the reference vit-pytorch 0.33.2 layout)')
    p.add_argument('--stats', default=None, choices=[None, 'original', 'denoised'],
                   help='PTB-XL per-lead normalization statistics')


def _model_cfg_for(args):
    from .configs import VitConfig
    from .utils.check_args import ca
    ca(model_size=args.size)
    return VitConfig.from_defined(args.size, dtype='bfloat16' if args.bf16 else 'float32',
                                  patch_norm=args.patch_norm)


def _load_splits(args):
    from .data import get_ptbxl_splits, synth_ptbxl
    print('[cli] using a synthetic PTB-XL-shaped corpus', file=sys.stderr)
    signals, labels, folds = synth_ptbxl(n=args.synth_n)
    return get_ptbxl_splits(signals, labels, folds)


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


def cmd_train(args):
    from .configs import TrainConfig
    from .train import Trainer
    splits = _load_splits(args)
    cfg = TrainConfig(
        num_train_epoch=args.epochs, train_batch_size=args.batch_size,
        eval_batch_size=args.batch_size, learning_rate=args.lr,
        weight_decay=args.weight_decay, schedule=args.schedule,
        warmup_ratio=args.warmup_ratio, patience=args.patience,
        augment_timeout=args.timeout_augment, seed=args.seed,
        grad_accum=args.grad_accum, ema_decay=args.ema_decay)
    tr = Trainer(_model_cfg_for(args), cfg, train_data=splits.train,
                 eval_data=splits.eval, norm_stats=_stats(args),
                 output_dir=args.output_dir)
    if args.resume_from:
        tr.load_checkpoint(args.resume_from)
    result = tr.train()
    test_metrics = tr.evaluate(splits.test)
    print(json.dumps({'best_eval_loss': result['best_eval_loss'],
                      'test_macro_auc': test_metrics['macro_auc'],
                      'epochs': result['epochs']}))


def cmd_evaluate(args):
    from .configs import TrainConfig
    from .train import Trainer
    from .train.evaluate import evaluate_trained
    splits = _load_splits(args)
    tr = Trainer(_model_cfg_for(args), TrainConfig(ema_decay=args.ema_decay,
                                                   eval_batch_size=args.batch_size),
                 eval_data=splits.eval, norm_stats=_stats(args))
    tr.init_state()
    if args.checkpoint:
        _load_ckpt(tr, args)
    results = evaluate_trained(tr, {'eval': splits.eval, 'test': splits.test},
                               out_dir=args.out)
    print(json.dumps({k: v.get('macro_auc') for k, v in results.items()
                      if isinstance(v, dict)}))


def cmd_serve(args):
    """Run the batch-inference HTTP server on the GPU (serving.py)."""
    from .configs import TrainConfig
    from .serving import serve
    from .train import Trainer
    tr = Trainer(_model_cfg_for(args), TrainConfig(eval_batch_size=args.batch_size,
                                                   ema_decay=args.ema_decay),
                 norm_stats=_stats(args))
    tr.init_state()
    if args.checkpoint:
        _load_ckpt(tr, args)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog='ecg-torch')
    sub = p.add_subparsers(dest='cmd', required=True)
    for name, fn in (('train', cmd_train), ('evaluate', cmd_evaluate)):
        sp = sub.add_parser(name)
        _add_common_train_flags(sp)
        sp.add_argument('--synth-n', type=int, default=512)
        if name == 'train':
            sp.add_argument('--resume-from', default=None)
        if name == 'evaluate':
            sp.add_argument('--checkpoint', default=None)
            sp.add_argument('--out', default='eval')
        sp.set_defaults(fn=fn)
    psv = sub.add_parser('serve', help='HTTP batch-inference server '
                                       '(GET /health, POST /predict)')
    _add_common_train_flags(psv)
    psv.add_argument('--checkpoint', default=None,
                     help='a port checkpoint (ckpt-* directory) to serve; '
                          'default: a seeded random init')
    psv.add_argument('--host', default='127.0.0.1')
    psv.add_argument('--port', type=int, default=8000)
    psv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()
