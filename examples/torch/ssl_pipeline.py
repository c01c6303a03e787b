"""SSL walkthrough of the PyTorch port through its CLI (the twin of
``examples/ssl_pipeline.py``): pretrain -> linear probe -> fine-tune.

It drives the port's command-line interface with the commands a user
types, end to end on a synthetic PTB-XL-shaped corpus:

  1. ``cli synth``      -- write a PTB-XL-shaped corpus (HDF5 + labels CSV)
  2. ``cli pretrain --objective mae``      -- masked-patch reconstruction
  3. ``cli train --init-encoder --probe``  -- LINEAR PROBE: frozen trunk,
                                              train only the classifier head
  4. ``cli train --init-encoder``          -- FULL FINE-TUNE from the trunk
  5. ``cli train`` (no init)               -- from-scratch control (--control)
  6. ``cli evaluate --checkpoint ...``     -- AUROC report JSON on disk

Run:  python examples/torch/ssl_pipeline.py [--platform cpu]
      python examples/torch/ssl_pipeline.py --n 2048 --epochs 8 --control
(On the GPU by default; the HDF5 steps need h5py.)

The probe beating chance (0.5) with a FROZEN trunk shows that MAE
pretraining learned signal structure.  ``--objective contrastive`` is the
pretext that wins the label-scarce transfer comparison on the hard corpus.
A JAX checkpoint converted with ``tools/orbax_to_port.py`` can stand in for
step 2's output.
"""
import argparse
import contextlib
import functools
import io
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))


def run_cli(platform, *args):
    """Run one command of the port's CLI as a user would
    (``python -m ecg_representation_learning_tpu_torch.cli [--platform P] ...``)
    and return its JSON result (the last line it prints)."""
    from ecg_representation_learning_tpu_torch import cli
    argv = (['--platform', platform] if platform else []) + [str(a) for a in args]
    print('    $ ecg-torch', ' '.join(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def pipeline(work: str, n: int, epochs: int, size: str = 'debug', platform=None,
             control: bool = False) -> dict:
    """Steps 1-6 under ``work``; returns the test macro-AUROCs by leg."""
    data = os.path.join(work, 'data')
    os.makedirs(data, exist_ok=True)
    cli = functools.partial(run_cli, platform)
    print(f'[1/5] synth corpus ({n} records)')
    r = cli('synth', '--n', n, '--marker-classes', 8, '--out', data)
    corpus = ['--hdf5', r['hdf5'], '--labels-csv', r['labels_csv']]

    print('[2/5] MAE pretrain (masked-patch reconstruction, 75% mask)')
    r = cli('pretrain', '--objective', 'mae', '--size', size, '--epochs', epochs,
            '--batch-size', 64, '--lr', 1e-3, '--output-dir', os.path.join(work, 'mae'),
            *corpus)
    ssl_ckpt = r['checkpoint']
    print(f'    pretrain loss {r["pretrain_loss"]:.4f} -> {ssl_ckpt}')

    print('[3/5] linear probe (trunk FROZEN, head only)')
    r = cli('train', '--size', size, '--epochs', epochs, '--batch-size', 64, '--lr', 1e-2,
            '--init-encoder', ssl_ckpt, '--probe', '--output-dir', os.path.join(work, 'probe'),
            *corpus)
    aucs = {'probe': r['test_macro_auc']}
    print(f'    probe test macro-AUROC = {aucs["probe"]:.4f} (chance = 0.5)')

    print('[4/5] full fine-tune from the pretrained trunk')
    r = cli('train', '--size', size, '--epochs', epochs, '--batch-size', 64, '--lr', 1e-3,
            '--init-encoder', ssl_ckpt, '--output-dir', os.path.join(work, 'finetune'),
            *corpus)
    aucs['finetune'] = r['test_macro_auc']
    print(f'    fine-tune test macro-AUROC = {aucs["finetune"]:.4f}')

    if control:
        print('[+]   from-scratch control (same budget, no SSL init)')
        r = cli('train', '--size', size, '--epochs', epochs, '--batch-size', 64, '--lr', 1e-3,
                '--output-dir', os.path.join(work, 'scratch'), *corpus)
        aucs['scratch'] = r['test_macro_auc']
        print(f'    scratch test macro-AUROC = {aucs["scratch"]:.4f}')

    print('[5/5] offline evaluation report on the fine-tuned checkpoint')
    r = cli('evaluate', '--size', size, '--checkpoint',
            os.path.join(work, 'finetune', 'ckpt-final'), '--out', os.path.join(work, 'eval'),
            *corpus)
    print(f'    report splits: {r}')
    return aucs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--platform', default=None, choices=['cuda', 'cpu'])
    ap.add_argument('--n', type=int, default=384, help='synthetic corpus size')
    ap.add_argument('--epochs', type=int, default=3)
    ap.add_argument('--size', default='debug', help='model size ladder name')
    ap.add_argument('--control', action='store_true',
                    help='also run the from-scratch control')
    ap.add_argument('--workdir', default=None)
    args = ap.parse_args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix='ssl-pipeline-')
    print(f'workdir: {work}')
    aucs = pipeline(work, args.n, args.epochs, args.size, args.platform, args.control)
    print('\nsummary')
    for leg, auc in aucs.items():
        print(f'  {leg:<13}  macro-AUROC {auc:.4f}')
    print(f'  artifacts under {work}')
    if not (aucs['probe'] > 0.5):
        raise SystemExit('probe did not beat chance -- SSL handoff broken?')


if __name__ == '__main__':
    main()
