"""Command-line interface of the port.

    python -m ecg_representation_learning_tpu_torch.cli serve --size base --stats original

Only ``serve`` is ported so far.  It serves a seeded random init: loading
trained weights (``--checkpoint``, ``--port-checkpoint``) arrives with the
checkpoint slice.
"""
from __future__ import annotations

import argparse
import json


def cmd_serve(args):
    """Run the batch-inference HTTP server on the GPU (serving.py)."""
    from .configs import TrainConfig, VitConfig
    from .registry import PTBXL_TRAIN_STATS
    from .serving import serve
    from .train import Trainer
    from .utils.check_args import ca
    ca(model_size=args.size)
    model_cfg = VitConfig.from_defined(
        args.size, dtype='bfloat16' if args.bf16 else 'float32')
    tr = Trainer(model_cfg, TrainConfig(eval_batch_size=args.batch_size),
                 norm_stats=PTBXL_TRAIN_STATS[args.stats] if args.stats else None)
    tr.init_state()
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
    psv = sub.add_parser(
        'serve', help='HTTP batch-inference server (GET /health, POST /predict)',
        description='Serves a seeded random init of the chosen size; loading '
                    'trained weights (--checkpoint, --port-checkpoint) waits '
                    'for the checkpoint slice of the port.')
    psv.add_argument('--size', default='base',
                     choices=['debug', 'tiny', 'small', 'base', 'large'])
    psv.add_argument('--bf16', action=argparse.BooleanOptionalAction, default=True,
                     help='bfloat16 Linear layers (--no-bf16 for float32)')
    psv.add_argument('--stats', default=None, choices=[None, 'original', 'denoised'],
                     help='PTB-XL per-lead normalization statistics')
    psv.add_argument('--batch-size', type=int, default=64,
                     help='device batch: every dispatch is padded to it')
    psv.add_argument('--host', default='127.0.0.1')
    psv.add_argument('--port', type=int, default=8000)
    psv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()
