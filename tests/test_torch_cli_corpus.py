"""The disk-corpus round trip through the port's CLI, against the JAX CLI.

``synth`` -> ``train --hdf5 --labels-csv --n-sample`` (reference layout,
f16-resident) -> the trained weights written as a vit-pytorch 0.33.2 ``.pt``
-> ``evaluate --pick-edge-samples`` and ``infer [--int8]`` from that ``.pt``
(``--port-checkpoint``) on both CLIs -> ``port`` -> ``evaluate --checkpoint``
of the ported checkpoint.  At the same weights the edge-sample indices and
the top-k codes must equal the JAX CLI's; the probabilities are held at
1e-5, the bar of ``tests/test_torch_serving.py::test_predict_matches_jax``.
Both sides run in f32 (``--no-bf16``) on the CPU.
"""
import glob
import json
import pickle

import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu import cli as jcli
from ecg_representation_learning_tpu.data import write_combined_hdf5 as jax_write_hdf5
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.models.port import (export_vit_pytorch_state_dict,
                                                               port_vit_pytorch_state_dict,
                                                               reference_vit_config)
from ecg_representation_learning_tpu_torch.train import checkpoint
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)
COMMON = ['--size', 'debug', '--no-bf16']


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """(data dir, corpus paths, reference .pt, trained state_dict) of one
    port ``train`` on the ``synth`` corpus."""
    d = tmp_path_factory.mktemp('corpus')
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))
        cli.main(['synth', '--n', '80', '--marker-classes', '4', '--out', str(d)])
        data = ['--hdf5', str(d / 'PTB-XL-combined.hdf5'),
                '--labels-csv', str(d / 'ptb-xl-labels.csv')]
        cli.main(['train', *COMMON, '--no-patch-norm', '--epochs', '1', '--batch-size', '16',
                  '--n-sample', '48', '--resident-dtype', 'float16', *data,
                  '--output-dir', str(d / 'run')])
    trained = checkpoint.restore_checkpoint(str(d / 'run' / 'ckpt-final'))['params']
    cfg = reference_vit_config('debug')
    ref = d / 'reference.pt'
    torch.save({k: torch.from_numpy(v) for k, v in
                export_vit_pytorch_state_dict(trained, cfg).items()}, ref)
    return d, data, str(ref), trained


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))


def _edge_samples(out_dir):
    (path,) = glob.glob(f'{out_dir}/eval_edge_example_samples, *.pkl')
    with open(path, 'rb') as f:
        return pickle.load(f)


def test_evaluate_picks_the_jax_edge_samples(run, on_cpu, tmp_path, capsys):
    d, data, ref, _ = run
    jcli.main(['evaluate', *COMMON, *data, '--port-checkpoint', ref, '--pick-edge-samples',
               '--out', str(tmp_path / 'jax')])
    want_auc = _last_json(capsys)
    cli.main(['evaluate', *COMMON, *data, '--port-checkpoint', ref, '--pick-edge-samples',
              '--out', str(tmp_path / 'port')])
    got_auc = _last_json(capsys)
    want = _edge_samples(tmp_path / 'jax')
    assert _edge_samples(tmp_path / 'port') == want
    assert set(want) == {'eval', 'test'} and all(len(v['low']) == 3 for v in want.values())
    assert set(got_auc) == set(want_auc) == {'eval', 'test'}
    for k in want_auc:
        np.testing.assert_allclose(got_auc[k], want_auc[k], atol=1e-6)
    # the trained checkpoint itself gives the same picks
    cli.main(['evaluate', *COMMON, '--no-patch-norm', *data, '--checkpoint',
              str(d / 'run' / 'ckpt-final'), '--pick-edge-samples',
              '--out', str(tmp_path / 'ckpt')])
    assert _edge_samples(tmp_path / 'ckpt') == want


def _infer(main, argv, out):
    main(['infer', *argv, '--out', str(out)])
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize('int8', [False, True])
def test_infer_top_k_matches_the_jax_cli(run, on_cpu, tmp_path, int8):
    d, _, ref, _ = run
    argv = [*COMMON, '--hdf5', str(d / 'PTB-XL-combined.hdf5'), '--port-checkpoint', ref,
            '--top-k', '3'] + (['--int8'] if int8 else [])
    want = _infer(jcli.main, argv, tmp_path / 'jax.json')
    got = _infer(cli.main, argv, tmp_path / 'port.json')
    assert got['n_records'] == want['n_records'] == 80 and got['top_k'] == 3
    for g, w in zip(got['records'], want['records']):
        assert g['record'] == w['record']
        assert [c['code'] for c in g['top']] == [c['code'] for c in w['top']]
        np.testing.assert_allclose([c['prob'] for c in g['top']],
                                   [c['prob'] for c in w['top']], atol=1e-5, rtol=0)


def test_infer_numbers_the_processed_rows_as_jax(run, on_cpu, tmp_path):
    """A partially denoised file: all-zero records are skipped and the
    others numbered in load order, as the JAX CLI does."""
    d, _, ref, _ = run
    x = np.random.default_rng(0).standard_normal((9, 12, 2500)).astype(np.float32)
    x[[1, 4]] = 0.0
    h5 = jax_write_hdf5(str(tmp_path / 'partial.hdf5'), x)
    argv = [*COMMON, '--hdf5', h5, '--port-checkpoint', ref]
    want = _infer(jcli.main, argv, tmp_path / 'jax.json')
    got = _infer(cli.main, argv, tmp_path / 'port.json')
    assert got['n_records'] == want['n_records'] == 7
    assert [r['record'] for r in got['records']] == list(range(7))
    assert [[c['code'] for c in r['top']] for r in got['records']] == \
        [[c['code'] for c in r['top']] for r in want['records']]


def test_port_writes_the_reference_weights_as_a_checkpoint(run, on_cpu, tmp_path, capsys):
    d, data, ref, trained = run
    cli.main(['port', *COMMON, '--port-checkpoint', ref, '--out', str(tmp_path)])
    printed = _last_json(capsys)
    assert printed['checkpoint'] == str(tmp_path / 'ckpt-ported') and printed['size'] == 'debug'
    params = checkpoint.restore_checkpoint(printed['checkpoint'])['params']
    want = port_vit_pytorch_state_dict(torch.load(ref, weights_only=True),
                                       reference_vit_config('debug'))
    assert set(params) == set(want) == set(trained)
    assert all(torch.equal(params[k], want[k]) and torch.equal(params[k], trained[k])
               for k in want)
    # --checkpoint of the ported checkpoint scores as --port-checkpoint does
    cli.main(['evaluate', *COMMON, '--no-patch-norm', *data, '--checkpoint',
              printed['checkpoint'], '--out', str(tmp_path / 'a')])
    from_ckpt = _last_json(capsys)
    cli.main(['evaluate', *COMMON, *data, '--port-checkpoint', ref,
              '--out', str(tmp_path / 'b')])
    assert _last_json(capsys) == from_ckpt


def test_serve_takes_the_reference_weights_in_int8(run, on_cpu, monkeypatch):
    _, _, ref, trained = run
    served = []

    class FakeServer:
        server_address = ('127.0.0.1', 0)
        service = type('S', (), {'close': lambda self: None})()

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass
    from ecg_representation_learning_tpu_torch import serving
    monkeypatch.setattr(serving, 'serve', lambda tr, **kw: served.append(tr) or FakeServer())
    cli.main(['serve', *COMMON, '--port-checkpoint', ref, '--int8'])
    (tr,) = served
    assert not tr.model_cfg.patch_norm and tr._int8 is not None
    assert all(torch.equal(v, trained[k]) for k, v in tr.model.state_dict().items())
    assert set(tr._int8['qweights']) == {k for k in trained
                                         if k.endswith('weight') and trained[k].dim() == 2}
