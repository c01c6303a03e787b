"""The port's training slice against the JAX package's ``Trainer``.

One JAX ``Trainer.train()`` per module (its step compiles once): the debug
ViT on the synthetic corpus, dropout off, with EMA and gradient
accumulation on, 2 epochs.  The port's ``Trainer`` starts from the same
weights (``vit_state_dict_from_flax``) and the same batch order (host
shuffle from ``cfg.seed``), and its loss curve must match step for step.
The JAX side sets ``prng_impl`` to the current global, because its trainer
writes that global.

Tolerance: losses, gradient norms and eval losses to rtol 1e-5.  Both sides
compute in f32 in another operation order; measured 3.2e-7 at worst over
the 10 steps (5 an epoch), and an Adam step can turn a rounding-level
difference of a gradient's sign into a 2 * lr difference of that weight,
which stays far below 1e-5 of the loss at this size.  The learning rate is
held as tests/test_torch_optim.py holds the schedules: rtol 1e-6 with atol
1e-6 of the peak, since numpy's and XLA's f32 cosine differ in the last bit
and 1 + cos cancels near the end of the decay.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu import cli as jcli
from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.data import get_ptbxl_splits as jax_splits
from ecg_representation_learning_tpu.data import synth_ptbxl
from ecg_representation_learning_tpu.train import Trainer as JaxTrainer
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits
from ecg_representation_learning_tpu_torch.models.port import vit_state_dict_from_flax
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer
from ecg_representation_learning_tpu_torch.train import checkpoint, trainer as ttrainer

torch.set_num_threads(2)
RTOL = 1e-5
KW = dict(num_train_epoch=2, train_batch_size=32, eval_batch_size=32, learning_rate=1e-3,
          log_to_console=False, save_final=False, ema_decay=0.9, grad_accum=2)


def _recording(tr):
    """Record every payload the trainer logs."""
    payloads, log = [], tr._log
    tr._log = lambda p: (payloads.append(p), log(p))
    return payloads


@pytest.fixture(scope='module')
def corpus():
    signals, labels, folds = synth_ptbxl(n=192, length=640)
    return (signals, labels, folds), get_ptbxl_splits(signals, labels, folds)


@pytest.fixture(scope='module')
def jax_run(corpus, tmp_path_factory):
    """(JAX payloads, JAX result, init params, JAX eval output, model cfg)."""
    raw, _ = corpus
    splits = jax_splits(*raw)
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=704,
                                     hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(**KW, prng_impl=jax.config.jax_default_prng_impl),
                     train_data=splits.train, eval_data=splits.eval,
                     output_dir=str(tmp_path_factory.mktemp('jax')))
    payloads = _recording(jtr)
    jtr.init_state()
    params = jax.tree.map(np.asarray, jtr.state.params)
    result = jtr.train()
    evaluated = jtr.evaluate(splits.test, loss_reduction='none', return_predictions=True)
    return payloads, result, params, evaluated, VitConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope='module')
def port_run(corpus, jax_run, tmp_path_factory):
    _, splits = corpus
    _, _, params, _, cfg = jax_run
    tr = Trainer(cfg, TrainConfig(**KW), train_data=splits.train, eval_data=splits.eval,
                 output_dir=str(tmp_path_factory.mktemp('port')), device='cpu')
    payloads = _recording(tr)
    tr.set_params(vit_state_dict_from_flax(params, cfg))
    return payloads, tr.train(), tr


def test_loss_curve_matches_jax_step_for_step(jax_run, port_run):
    jp, jres, *_ = jax_run
    tp, tres, tr = port_run
    assert [sorted(p) for p in tp] == [sorted(p) for p in jp]
    train = [(a, b) for a, b in zip(jp, tp) if 'train/loss' in a]
    assert len(train) == tr.steps_per_epoch * 2 == tr.step == 10
    for a, b in zip(jp, tp):
        assert (a['epoch'], a['step']) == (b['epoch'], b['step'])
        for key in ('train/loss', 'train/grad_norm', 'eval/loss'):
            if key in a:
                np.testing.assert_allclose(b[key], a[key], rtol=RTOL, err_msg=key)
        if 'train/learning_rate' in a:
            np.testing.assert_allclose(b['train/learning_rate'], a['train/learning_rate'],
                                       rtol=1e-6, atol=1e-6 * KW['learning_rate'])
    assert tres['epochs'] == jres['epochs'] == 2
    np.testing.assert_allclose(tres['best_eval_loss'], jres['best_eval_loss'], rtol=RTOL)
    np.testing.assert_allclose([h['macro_auc'] for h in tres['history']],
                               [h['macro_auc'] for h in jres['history']], atol=1e-6)


def test_eval_payload_has_the_jax_keys(corpus, jax_run, port_run):
    _, splits = corpus
    want = jax_run[3]
    got = port_run[2].evaluate(splits.test, loss_reduction='none', return_predictions=True)
    assert set(got) == set(want)
    assert set(got['classification_report']) == set(want['classification_report'])
    assert got['per_sample_loss'].shape == want['per_sample_loss'].shape
    np.testing.assert_allclose(got['loss'], got['per_sample_loss'].mean(), rtol=1e-6)
    np.testing.assert_allclose(got['predictions']['probs'], want['predictions']['probs'],
                               atol=1e-4)
    np.testing.assert_array_equal(got['predictions']['labels'], want['predictions']['labels'])


def _trainer(splits, tmp_path, **kw):
    cfg = VitConfig.from_defined('debug', max_signal_length=704, flash_min_seq=0,
                                 dropout_impl=kw.pop('dropout_impl', 'flax'))
    base = dict(num_train_epoch=1, train_batch_size=32, eval_batch_size=32,
                learning_rate=1e-3, log_to_console=False, augment_timeout=True)
    return Trainer(cfg, TrainConfig(**{**base, **kw}), train_data=splits.train,
                   eval_data=splits.eval, output_dir=str(tmp_path), device='cpu')


@pytest.mark.parametrize('dropout_impl', ['flax', 'hash'])
def test_exact_resume_from_a_port_checkpoint(corpus, tmp_path, dropout_impl):
    """Params, moments, count, step, epoch, EMA and the generators round-trip,
    so the next step (dropout, TimeOut) is the same as without the restart."""
    _, splits = corpus
    tr = _trainer(splits, tmp_path, do_eval=False, ema_decay=0.5, dropout_impl=dropout_impl)
    tr.train()
    path = tr.save_checkpoint(tag='resume-test')
    tr2 = _trainer(splits, tmp_path, do_eval=False, ema_decay=0.5, dropout_impl=dropout_impl)
    tr2.init_state(seed=123)
    tr2.load_checkpoint(path)
    assert (tr2.step, tr2.epoch, tr2.opt_state.count) == (tr.step, tr.epoch, tr.opt_state.count)
    for name, state in (('params', lambda t: t.model.state_dict()), ('ema', lambda t: t.ema),
                        ('mu', lambda t: t.opt_state.mu), ('nu', lambda t: t.opt_state.nu)):
        a, b = state(tr), state(tr2)
        assert all(torch.equal(a[k], b[k]) for k in a), name
    take = np.arange(32)
    m1, m2 = tr.train_step(splits.train, take), tr2.train_step(splits.train, take)
    assert float(m1['loss']) == float(m2['loss'])
    assert all(torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                                 tr2.model.state_dict().values()))
    assert tr.evaluate(splits.eval)['loss'] == tr2.evaluate(splits.eval)['loss']
    assert checkpoint.latest_committed_checkpoint(str(tmp_path)) in (
        path, str(tmp_path / 'ckpt-final'))


def test_checkpoint_listing_skips_unfinished_saves(tmp_path):
    state = {'step': 1, 'params': {'w': torch.ones(2)}}
    a = checkpoint.save_checkpoint(str(tmp_path / 'ckpt-step2'), state)
    b = checkpoint.save_checkpoint(str(tmp_path / 'ckpt-step10'), state)
    (tmp_path / 'ckpt-step11.tmp-99').mkdir()              # a save killed midway
    assert checkpoint.committed_checkpoints(str(tmp_path)) == [a, b]
    assert torch.equal(checkpoint.restore_checkpoint(b)['params']['w'], torch.ones(2))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / 'ckpt-step11.tmp-99'))


def test_restore_handles_ema_and_moment_dtype_skew(corpus, tmp_path):
    _, splits = corpus
    tr = _trainer(splits, tmp_path, do_eval=False, save_final=False, ema_decay=0.5)
    tr.init_state()
    path = tr.save_checkpoint('skew')
    plain = _trainer(splits, tmp_path, do_eval=False, adam_mu_dtype='bfloat16')
    plain.load_checkpoint(path)
    assert plain.last_restore_info.get('dropped_ema') and plain.ema is None
    assert plain.opt_state.mu['head.bias'].dtype == torch.bfloat16   # reinitialized
    other = Trainer(VitConfig.from_defined('tiny', max_signal_length=704),
                    TrainConfig(log_to_console=False), device='cpu')
    with pytest.raises(ValueError, match='do not match'):
        other.load_checkpoint(path)


def test_early_stopping(corpus, tmp_path):
    """lr 0: the eval loss never improves after the first epoch."""
    _, splits = corpus
    tr = _trainer(splits, tmp_path, num_train_epoch=10, learning_rate=0.0, patience=2,
                  save_final=False)
    result = tr.train()
    assert result['epochs'] == 3 and len(result['history']) == 3
    assert (tmp_path / 'ckpt-best').is_dir() and not (tmp_path / 'ckpt-final').exists()


def test_nonfinite_gradients_raise_and_leave_the_params_clean(corpus, tmp_path):
    _, splits = corpus
    signals = splits.train.signals.copy()
    signals[:] = np.nan
    tr = _trainer(splits, tmp_path, save_final=False, do_eval=False, augment_timeout=False)
    tr.train_data = SplitData(signals=signals, labels=splits.train.labels)
    tr.init_state()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    with pytest.raises(FloatingPointError, match='non-finite gradient norm by step 1'):
        tr.train()
    # the zeroed step still decays the weights: p - lr * wd * p, as in JAX
    lr, wd = tr.optimizer.lr_at(0), tr.cfg.weight_decay
    for k, v in tr.model.state_dict().items():
        assert torch.isfinite(v).all(), k
        torch.testing.assert_close(v, before[k] - lr * (wd * before[k]), rtol=1e-6, atol=0)


def test_resident_and_streamed_splits_give_the_same_step(corpus, tmp_path):
    _, splits = corpus
    losses = []
    for resident in (True, False):
        tr = _trainer(splits, tmp_path, device_resident=resident, augment_timeout=False)
        tr.init_state()
        losses.append(float(tr.train_step(splits.train, np.arange(5, 37))['loss']))
        assert bool(tr._resident) == resident
    assert losses[0] == losses[1]


class _Parsed(Exception):
    """Raised with the JAX CLI's parser in place of parsing."""


def _subcommands(parser):
    return next(a for a in parser._actions if a.dest == 'cmd').choices


def _flags(sp):
    """{flag: (default, required)} of a subcommand."""
    return {a.option_strings[-1]: (a.default, a.required) for a in sp._actions
            if a.option_strings and a.dest != 'help'}


# flags the port adds to a JAX subcommand
PORT_ONLY = {'denoise': {'--device'}}
# flags of this slice that each subcommand must have
REQUIRED = {
    'train': {'--hdf5', '--labels-csv', '--n-sample', '--resident-dtype', '--port-checkpoint'},
    'pretrain': {'--hdf5', '--labels-csv', '--n-sample', '--resident-dtype'},
    'evaluate': {'--hdf5', '--labels-csv', '--n-sample', '--port-checkpoint',
                 '--pick-edge-samples', '--checkpoint'},
    'serve': {'--checkpoint', '--port-checkpoint', '--int8', '--stats'},
    'infer': {'--hdf5', '--stats', '--checkpoint', '--port-checkpoint', '--top-k', '--int8',
              '--out', '--size', '--no-bf16', '--batch-size', '--ema-decay'},
    'port': {'--port-checkpoint', '--out', '--size', '--no-bf16'},
    'synth': {'--n', '--seed', '--marker-classes', '--hard', '--out'},
    'export-model': {'--stats', '--checkpoint', '--port-checkpoint', '--int8',
                     '--signal-length', '--platforms', '--out', '--ema-decay'},
    'tokenize': {'--hdf5', '--synth-n', '--k', '--pad', '--clusters', '--iters', '--seed',
                 '--out'},
    'visualize': {'--hdf5', '--labels-csv', '--synth-n', '--stats', '--checkpoint', '--split',
                  '--index', '--ema-decay'},
}


def test_cli_flags_are_the_jax_names_and_defaults(monkeypatch):
    """Every JAX subcommand is in the port, and every flag of every port
    subcommand is the JAX CLI's, with its default (and whether it is
    required); the disk-corpus and tools flags are all there."""
    def capture(self, *args, **kw):
        raise _Parsed(self)
    with monkeypatch.context() as m:
        m.setattr(jcli.argparse.ArgumentParser, 'parse_args', capture)
        with pytest.raises(_Parsed) as parsed:
            jcli.main([])
    jsub = _subcommands(parsed.value.args[0])
    sub = _subcommands(cli.build_parser())
    assert set(REQUIRED) | {'denoise'} <= set(sub) == set(jsub)
    for name, sp in sub.items():
        got, want = _flags(sp), _flags(jsub[name])
        assert set(got) - set(want) == PORT_ONLY.get(name, set()), name
        assert {k: want[k] for k in got if k in want} == \
            {k: v for k, v in got.items() if k in want}, name
        assert REQUIRED.get(name, set()) <= set(got), name
    assert set(_flags(sub['synth'])) == set(_flags(jsub['synth']))


def test_cli_train_evaluate_and_serve_a_checkpoint(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))
    out = str(tmp_path / 'run')
    cli.main(['train', '--size', 'debug', '--epochs', '1', '--batch-size', '16',
              '--synth-n', '96', '--no-bf16', '--output-dir', out])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {'best_eval_loss', 'test_macro_auc', 'epochs'}
    cli.main(['evaluate', '--size', 'debug', '--synth-n', '96', '--no-bf16',
              '--checkpoint', f'{out}/ckpt-final', '--out', str(tmp_path / 'eval')])
    assert set(json.loads(capsys.readouterr().out.strip().splitlines()[-1])) == {'eval', 'test'}
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
    cli.main(['serve', '--size', 'debug', '--no-bf16', '--checkpoint', f'{out}/ckpt-final'])
    want = checkpoint.restore_checkpoint(f'{out}/ckpt-final')['params']
    assert all(torch.equal(v, want[k]) for k, v in served[0].model.state_dict().items())
