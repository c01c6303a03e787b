"""The PyTorch port's examples (``examples/torch/``) run on the CPU.

Each example is the twin of a JAX example under ``examples/`` and runs at a
toy size here (a few dozen records, 1 epoch) with ``--platform cpu``; by
default they run on the GPU, which the last test checks they ask for:

  * ``quickstart``: splits, supervised train + eval, MAE pretrain and the
    encoder transfer, the tokenizer, the rollout arrays and the figure
    (matplotlib, drawn here);
  * ``ssl_pipeline``: synth -> MAE pretrain -> probe -> fine-tune ->
    evaluate through the port's CLI, its artifacts on disk;
  * ``serving_demo``: 16 concurrent clients, f32 and ``--int8``: every
    client's row is ``predict`` of its own record;
  * ``parallel_training``: DP x TP + FSDP, GPipe and ring context
    parallelism on 4 gloo CPU ranks;
  * every example imports with JAX, the JAX package, h5py, pandas,
    matplotlib, seaborn and scikit-learn blocked (the GPU machine has none
    of them; the figure imports matplotlib when it is drawn).
"""
import importlib
import math
import os

import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch import runtime

torch.set_num_threads(2)


def _example(name):
    return importlib.import_module(f'examples.torch.{name}')


def test_quickstart_runs_each_stage_and_draws_the_figure(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _example('quickstart').main(['--platform', 'cpu', '--n', '48', '--epochs', '1'])
    out = capsys.readouterr().out
    for stage in ('splits:', 'supervised:', 'mae pretrain loss',
                  'pretrained encoder transferred', 'tokenizer:', 'rollout scores:',
                  'rollout figure:'):
        assert stage in out, stage
    figures = os.listdir(tmp_path / 'plots')
    assert len(figures) == 1 and os.path.getsize(tmp_path / 'plots' / figures[0]) > 0
    assert os.path.exists(tmp_path / 'runs' / 'quickstart' / 'ckpt-final')


def test_quickstart_rollout_arrays_are_the_rollout_of_the_maps():
    from ecg_representation_learning_tpu_torch.configs import VitConfig
    from ecg_representation_learning_tpu_torch.models import create_vit
    from ecg_representation_learning_tpu_torch.utils.rollout import attention_rollout
    qs = _example('quickstart')
    cfg = VitConfig.from_defined('debug', max_signal_length=320)
    model, _ = create_vit(cfg, torch.Generator().manual_seed(0))
    sig = np.random.default_rng(0).standard_normal((12, 250)).astype(np.float32)
    sig = np.pad(sig, [(0, 0), (0, 6)])
    maps, scores = qs.rollout_arrays(model, sig)
    assert maps.shape == (4, 1, 4, 5, 5) and scores.shape == (4, 4)
    np.testing.assert_array_equal(scores, attention_rollout(maps))


def test_ssl_pipeline_walks_the_cli(tmp_path, capsys):
    aucs = _example('ssl_pipeline').pipeline(str(tmp_path), n=160, epochs=1, platform='cpu')
    assert set(aucs) == {'probe', 'finetune'}
    assert all(0.0 <= v <= 1.0 for v in aucs.values())
    out = capsys.readouterr().out
    assert out.count('$ ecg-torch --platform cpu') == 5
    assert os.path.exists(tmp_path / 'mae' / 'ckpt-final')
    assert os.path.exists(tmp_path / 'finetune' / 'ckpt-final')
    assert any(f.endswith('.json') for f in os.listdir(tmp_path / 'eval'))


@pytest.mark.parametrize('int8', [False, True])
def test_serving_demo_answers_every_client_with_its_own_row(int8, capsys):
    demo = _example('serving_demo')
    demo.main(['--platform', 'cpu', '--clients', '16'] + (['--int8'] if int8 else []))
    out = capsys.readouterr().out
    assert '16/16 clients got their own correct row' in out
    assert ('int8:' in out) == int8


def test_parallel_training_runs_the_three_modes_on_four_ranks(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    res = _example('parallel_training').main(['--platform', 'cpu', '--ranks', '4'])
    assert res['dp_tp']['mesh'] == {'data': 2, 'model': 2}
    assert math.isfinite(res['dp_tp']['eval_loss'])
    # TP halves the qkv rows, FSDP the columns
    assert res['dp_tp']['qkv_shard'] == (3 * 64 // 2, 64 // 2)
    assert res['pipeline']['stages'] == 2 and res['pipeline']['stage_qkv'][0] == 2
    assert math.isfinite(res['pipeline']['loss'])
    assert res['ring']['shards'] == 4 and all(math.isfinite(v) for v in res['ring']['losses'])


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _example('serving_demo').build_trainer()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _example('quickstart').tokenize(None)
    assert runtime.default_device('cpu') == torch.device('cpu')


def test_examples_import_without_jax_or_matplotlib():
    import test_torch_imports as imports
    modules = [f'examples.torch.{n}' for n in
               ('quickstart', 'ssl_pipeline', 'serving_demo', 'parallel_training')]
    res = imports._run(f'MODULES = {modules!r}\nCHIP_SMOKE = '
                       f'{str(imports.ROOT / "chip_smoke.py")!r}\n' + imports.BLOCKER)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f'ok {len(modules)}'
