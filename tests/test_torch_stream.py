"""The port's streaming pretraining path (data/pipeline.py, data/torch_adapter.py,
utils/misc.StepTimer, train/checkpoint.prune_checkpoints, the stream pair of
train/pretrain.py and train/contrastive.py, cli pretrain --stream) against
the JAX package's.

Against JAX, on the same numpy inputs:
  * ``ShardedRecordStream`` (looping, over two epochs, with and without
    ``drop_last``, int16 kept by ``dtype=None``) and ``MixedRecordStream``:
    the same batches in the same order, and the same ``mix_counts``;
  * one MAE and one contrastive stream step on 500 Hz int16 input (wire
    scale 1000, the fused preprocess at the port's side on the CPU), each
    from the JAX state before it with the JAX step's mask noise or view
    draws replayed, dropout off: ``_check_steps``' tolerances
    (tests/test_torch_pretrain.py) -- loss rtol 1e-5, gradient norm rtol
    1e-4, parameters within 2.2 lr with 99 % within 1e-6;
  * ``TorchPtbxlDataset`` items as tests/test_torch_adapter.py has them, and
    equal to the JAX adapter's for a seed.
Then the port alone: ``train_stream``'s resume continues a deterministic
two-corpus stream bit for bit (dropout and EMA on); one step per (rate,
scale) key; checkpoint pruning; and ``cli export-shards`` -> ``cli pretrain
--stream`` over two corpora, killed (SIGKILL) in a subprocess after its
first checkpoint and resumed with ``--resume``, bit for bit the
uninterrupted run.
"""
import dataclasses
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.data import pipeline as jpipe
from ecg_representation_learning_tpu.data import torch_adapter as jadapter
from ecg_representation_learning_tpu.data import get_ptbxl_splits as jget_splits
from ecg_representation_learning_tpu.data import synth_ptbxl as jsynth
from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.train import contrastive as jtcon
from ecg_representation_learning_tpu.train import pretrain as jpre
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import MaeConfig, TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.data import (as_torch_dataset, get_ptbxl_splits,
                                                        synth_ptbxl)
from ecg_representation_learning_tpu_torch.data import pipeline
from ecg_representation_learning_tpu_torch.models.port import state_dict_from_flax
from ecg_representation_learning_tpu_torch.registry import PTBXL_TRAIN_STATS
from ecg_representation_learning_tpu_torch.train import checkpoint, optim
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer
from ecg_representation_learning_tpu_torch.train.contrastive import ContrastiveTrainer
from ecg_representation_learning_tpu_torch.train.pretrain import MaeTrainer
from ecg_representation_learning_tpu_torch.utils import tracing
from ecg_representation_learning_tpu_torch.utils.misc import StepTimer
from test_raw_tree_integration import _write_record
from test_torch_contrastive import jax_view_draws
from test_torch_pretrain import CC, CFG, JCC, JCFG, JMAE, MAE, _close, _flax_rng, _Patch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = PTBXL_TRAIN_STATS['original']
RAW_FQS, RAW_LEN, SCALE, BS = 500, 640, 1000.0, 8      # 640 @ 500 Hz -> 320 @ 250 Hz


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------
def _shards(tmp_path, sizes, rng, length=16, dtype=np.int16, name='s'):
    paths = []
    for i, n in enumerate(sizes):
        path = str(tmp_path / f'{name}-{i}.hdf5')
        data = (rng.normal(0, 300, (n, 2, length))).astype(dtype)
        with h5py.File(path, 'w') as f:
            f.create_dataset('data', data=data)
        paths.append(path)
    return paths


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g[0] == w[0]
            g, w = g[1], w[1]
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('drop_last,dtype', [(True, None), (False, np.float32)])
def test_sharded_stream_is_jax_over_two_epochs(drop_last, dtype, tmp_path, rng):
    paths = _shards(tmp_path, [13, 7, 10], rng)
    per_epoch = sum((n // 4) if drop_last else -(-n // 4) for n in (13, 7, 10))
    kw = dict(batch_size=4, seed=5, drop_last=drop_last, loop=True, dtype=dtype)
    got = list(itertools.islice(pipeline.ShardedRecordStream(paths, **kw), 2 * per_epoch))
    want = list(itertools.islice(jpipe.ShardedRecordStream(paths, **kw), 2 * per_epoch))
    _same_batches(got, want)
    assert got[0].dtype == (np.int16 if dtype is None else np.float32)
    once = list(pipeline.ShardedRecordStream(paths, batch_size=4, seed=5, drop_last=drop_last))
    assert len(once) == per_epoch      # loop=False stops after one epoch


def test_mixed_stream_is_jax_and_its_mix_counts(tmp_path, rng):
    corpora = [_shards(tmp_path, [9, 6], rng, name='a'),
               _shards(tmp_path, [12], rng, length=20, name='b'),
               _shards(tmp_path, [5, 5, 5], rng, length=8, name='c')]
    kw = dict(batch_size=3, weights=[0.5, 0.3, 0.2], seed=11)
    got = list(itertools.islice(pipeline.MixedRecordStream(corpora, **kw), 40))
    want = list(itertools.islice(jpipe.MixedRecordStream(corpora, **kw), 40))
    _same_batches(got, want)
    counts = np.bincount([i for i, _ in got], minlength=3)
    replay = np.random.default_rng(11)
    w = np.array([0.5, 0.3, 0.2]) / 1.0
    assert list(counts) == list(np.bincount(
        [int(replay.choice(3, p=w)) for _ in range(40)], minlength=3))


def test_early_stop_ends_the_shard_threads(tmp_path, rng):
    """Stopping a stream mid-shard (``islice``, then dropping it) stops its
    background threads instead of leaving them blocked on the queue."""
    corpora = [_shards(tmp_path, [20, 20, 20], rng, name=n) for n in 'ab']
    before = threading.active_count()
    it = iter(pipeline.MixedRecordStream(corpora, batch_size=2, seed=3))
    list(itertools.islice(it, 5))
    assert threading.active_count() > before
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_shard_read_error_reaches_the_consumer(tmp_path, rng):
    paths = _shards(tmp_path, [4], rng) + [str(tmp_path / 'missing.hdf5')]
    with pytest.raises(OSError):
        list(pipeline.ShardedRecordStream(paths, batch_size=2, seed=0))


def test_prefetch_on_the_cpu_passes_through_and_refuses_sharding(rng):
    items = [(0, np.arange(6, dtype=np.int16)), (1, np.ones(3, np.float32))]
    out = list(pipeline.prefetch_to_device(iter(items), depth=2, device='cpu'))
    assert all(a is b for (_, a), (_, b) in zip(out, items))
    with pytest.raises(TypeError, match='sharding'):   # a Mesh, or nothing
        pipeline.prefetch_to_device(iter(items), sharding=object(), device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            pipeline.prefetch_to_device(iter(items))


def test_device_batches_are_jax(rng):
    sig = rng.standard_normal((22, 3, 5)).astype(np.float32)
    lab = rng.standard_normal((22, 2)).astype(np.float32)
    got = list(pipeline.device_batches(sig, lab, 4, np.random.default_rng(1), device='cpu'))
    want = list(jpipe.device_batches(sig, lab, 4, np.random.default_rng(1)))
    assert len(got) == len(want) == 5
    for (gs, gl), (ws, wl) in zip(got, want):
        np.testing.assert_array_equal(gs, np.asarray(ws))
        np.testing.assert_array_equal(gl, np.asarray(wl))


# ---------------------------------------------------------------------------
# stream steps against JAX
# ---------------------------------------------------------------------------
STEP_KW = dict(num_train_epoch=3, train_batch_size=BS, eval_batch_size=BS,
               learning_rate=1e-3, log_to_console=False, save_final=False)


def _wire(seed, n=2):
    rng = np.random.default_rng(seed)
    return [np.clip(np.round(rng.normal(0, 0.4, (BS, 12, RAW_LEN)) * SCALE),
                    -32768, 32767).astype(np.int16) for _ in range(n)]


def _jax_stream_steps(jtr, module, batches, replay, monkeypatch):
    """JAX stream steps from ``jtr``'s init: per step (params and optimizer
    state before it, its loss, gradient norm and learning rate, the draws,
    params after it).  The gradient norm is read out of ``finish_update``
    with a debug callback."""
    norms = []
    finish = module.finish_update

    def spy(*args, **kw):
        out = finish(*args, **kw)
        jax.debug.callback(lambda g: norms.append(float(g)), out[1])
        return out
    monkeypatch.setattr(module, 'finish_update', spy)
    jtr.init_state()
    step = jtr.build_stream_step(raw_fqs=RAW_FQS, wire_scale=SCALE)
    out = []
    for k, sig in enumerate(batches):
        before = jax.tree.map(np.asarray, (jtr.state.params, jtr.state.opt_state))
        draws = replay(jax.random.split(jtr.state.rng, 3)[1])
        lr = float(jtr.schedule(k))
        with jtr.mesh:
            jtr.state, loss = step(jtr.state, jnp.asarray(sig))
        loss = float(loss)
        jax.effects_barrier()
        out.append((before, {'loss': loss, 'grad_norm': norms[-1], 'learning_rate': lr},
                    draws, jax.tree.map(np.asarray, jtr.state.params)))
    return out


def _check_stream_steps(tr, batches, steps, feed):
    """``_check_steps`` for the stream step: each port step from the JAX
    state before it."""
    tr.init_state()
    step = tr.build_stream_step(raw_fqs=RAW_FQS, wire_scale=SCALE)
    for k, ((params, opt), want, draws, after) in enumerate(steps):
        sd = state_dict_from_flax(params, tr.model)
        with torch.no_grad():
            for name, p in tr.params().items():
                p.copy_(sd[name])
        tr.opt_state = optim.FusedAdamWState(count=int(opt.count),
                                             mu=state_dict_from_flax(opt.mu, tr.model),
                                             nu=state_dict_from_flax(opt.nu, tr.model))
        tr.step = k
        with feed(draws):
            got = step(torch.from_numpy(batches[k]))
        _close(float(got['loss']), want['loss'], rtol=1e-5)
        _close(float(got['grad_norm']), want['grad_norm'], rtol=1e-4)
        lr = want['learning_rate']
        _close(tr.optimizer.lr_at(k), lr, rtol=1e-6, atol=1e-9)
        assert tr.step == k + 1
        want_after = state_dict_from_flax(after, tr.model)
        diffs = []
        for name, p in tr.params().items():
            _close(p.detach(), want_after[name], rtol=1e-5, atol=2.2 * lr + 1e-7)
            diffs.append((p.detach() - want_after[name]).abs().flatten())
        assert torch.quantile(torch.cat(diffs), 0.99) <= 1e-6


def test_mae_stream_step_matches_jax(monkeypatch):
    jtr = jpre.MaeTrainer(JCFG, JMAE, JaxTrainConfig(
        **STEP_KW, prng_impl=jax.config.jax_default_prng_impl), norm_stats=STATS)
    batches = _wire(3)
    n_patch = JCFG.max_signal_length // JCFG.patch_size
    steps = _jax_stream_steps(jtr, jpre, batches, lambda key: torch.from_numpy(
        np.array(jax.random.uniform(_flax_rng(key, 'mask'), (BS, n_patch)))), monkeypatch)
    tr = MaeTrainer(CFG, MAE, TrainConfig(**STEP_KW), norm_stats=STATS, device='cpu')
    forward = tr.model.forward

    def feed(noise):
        return _Patch(tr.model, 'forward', lambda x, rng=None: forward(x, rng, noise=noise))
    _check_stream_steps(tr, batches, steps, feed)


def test_contrastive_stream_step_matches_jax(monkeypatch):
    jtr = jtcon.ContrastiveTrainer(JCFG, JCC, JaxTrainConfig(
        **STEP_KW, prng_impl=jax.config.jax_default_prng_impl), norm_stats=STATS)
    batches = _wire(4)

    def replay(key):
        return [jax_view_draws(k, (BS, 12, RAW_LEN), CC) for k in jax.random.split(key)]
    steps = _jax_stream_steps(jtr, jtcon, batches, replay, monkeypatch)
    tr = ContrastiveTrainer(CFG, CC, TrainConfig(**STEP_KW), norm_stats=STATS, device='cpu')

    def feed(draws):
        return _Patch(tr, '_views', lambda sig, gen, prep=None: ContrastiveTrainer._views(
            tr, sig, gen, draws=draws, prep=prep))
    _check_stream_steps(tr, batches, steps, feed)


def test_stream_step_preprocess_is_chosen_by_key_not_shape():
    """500 Hz x 640 and 400 Hz x 512 both become 320 samples at 250 Hz; each
    key takes its own preprocess, and a 250 Hz batch only normalize + pad."""
    tr = MaeTrainer(CFG, MAE, TrainConfig(**STEP_KW), norm_stats=STATS, device='cpu')
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 0.4, (2, 12, 640)).astype(np.float32))
    a, b = tr._stream_prep(500)(x), tr._stream_prep(400)(x[..., :512])
    assert a.shape == b.shape == (2, 12, 320) and not torch.equal(a, b)
    assert tr._stream_prep(None) == tr._stream_prep(250) == tr._model_input


# ---------------------------------------------------------------------------
# train_stream on the port
# ---------------------------------------------------------------------------
class ArrayShards(pipeline.ShardedRecordStream):
    """Shards held in memory: ``path`` names an array of ``SHARDS``."""
    SHARDS = {}

    def _load_shard(self, path):
        return self.SHARDS[path]


class ArrayMix(pipeline.MixedRecordStream):
    stream_cls = ArrayShards


def _two_corpora():
    rng = np.random.default_rng(9)
    for name, length in (('a', 640), ('b', 512)):
        for i in range(2):
            ArrayShards.SHARDS[f'{name}{i}'] = np.round(
                rng.normal(0, 0.4, (12, 12, length)) * SCALE).astype(np.int16)
    return [['a0', 'a1'], ['b0', 'b1']]


def _stream_trainer(tmp_path, **kw):
    cfg = VitConfig.from_defined('debug', max_signal_length=320)     # dropout 0.1
    return MaeTrainer(cfg, MAE, TrainConfig(**{**STEP_KW, 'num_train_epoch': 6,
                                               'ema_decay': 0.5, **kw}),
                      norm_stats=STATS, output_dir=str(tmp_path), device='cpu')


def _run(tmp_path, total, **kw):
    tr = _stream_trainer(tmp_path)
    stream = ArrayMix(_two_corpora(), batch_size=BS, weights=[0.6, 0.4], seed=21)
    res = tr.train_stream(pipeline.prefetch_to_device(iter(stream), device='cpu'),
                          total_steps=total, raw_fqs=[500, 400], wire_scale=[SCALE, SCALE],
                          log_every=2, **kw)
    return tr, res


def test_train_stream_resume_is_bit_identical(tmp_path):
    full, res = _run(tmp_path / 'full', 6, ckpt_every=3)
    assert res['steps'] == 6 and np.isfinite(res['loss'])
    replay = np.random.default_rng(21)
    draws = [int(replay.choice(2, p=[0.6, 0.4])) for _ in range(6)]
    assert res['mix_counts'] == {i: draws.count(i) for i in sorted(set(draws))}
    assert set(res['timer']) == {'steps', 'input_s', 'compute_s', 'input_fraction',
                                 'steps_per_sec'}
    first, _ = _run(tmp_path / 'killed', 3, ckpt_every=3)
    assert first.step == 3
    resumed, res2 = _run(tmp_path / 'killed', 6, ckpt_every=3, resume=True)
    assert res2['steps'] == 6 and sum(res2['mix_counts'].values()) == 3
    assert res2['loss'] == res['loss']
    for name in ('params', 'ema'):
        a = full.model.state_dict() if name == 'params' else full.ema
        b = resumed.model.state_dict() if name == 'params' else resumed.ema
        assert all(torch.equal(a[k], b[k]) for k in a), name
    assert all(torch.equal(full.opt_state.mu[k], resumed.opt_state.mu[k])
               for k in full.opt_state.mu)


def test_train_stream_builds_one_step_per_key(tmp_path, monkeypatch):
    tr = _stream_trainer(tmp_path)
    keys = []
    build = tr.build_stream_step

    def spy(raw_fqs=None, wire_scale=None):
        keys.append((raw_fqs, wire_scale))
        return build(raw_fqs=raw_fqs, wire_scale=wire_scale)
    monkeypatch.setattr(tr, 'build_stream_step', spy)
    corpora = _two_corpora() + [['a1']]
    stream = ArrayMix(corpora, batch_size=BS, seed=2)
    res = tr.train_stream(iter(stream), total_steps=8, raw_fqs=[500, 400, 500],
                          wire_scale=[SCALE, SCALE, SCALE], log_every=4)
    assert sorted(keys) == [(400, SCALE), (500, SCALE)]
    assert sum(res['mix_counts'].values()) == 8 and len(res['mix_counts']) == 3


def test_train_stream_checkpoints_prune_and_final_save(tmp_path):
    tr, res = _run(tmp_path, 5, ckpt_every=2)
    tr.save_checkpoint('best')
    names = sorted(os.path.basename(p) for p in checkpoint.committed_checkpoints(str(tmp_path)))
    assert names == ['ckpt-best', 'ckpt-step4', 'ckpt-step5']
    checkpoint.prune_checkpoints(str(tmp_path), keep=1)
    names = sorted(os.path.basename(p) for p in checkpoint.committed_checkpoints(str(tmp_path)))
    assert names == ['ckpt-best', 'ckpt-step5']


def test_step_timer_summary(monkeypatch):
    clock = iter([0.0, 1.0, 4.0, 5.0, 8.0])
    # StepTimer lives in utils/tracing.py (utils.misc re-exports it)
    monkeypatch.setattr(tracing, 'time', types.SimpleNamespace(perf_counter=lambda: next(clock)))
    t = StepTimer()
    t.input_done()
    t.step_done()
    t.input_done()
    t.step_done()
    assert t.summary() == {'steps': 2, 'input_s': 2.0, 'compute_s': 6.0,
                           'input_fraction': 0.25, 'steps_per_sec': 0.25}


# ---------------------------------------------------------------------------
# the CLI: export-shards -> pretrain --stream, kill and resume
# ---------------------------------------------------------------------------
LEN_A, LEN_B = 1000, 800      # 500 Hz and 400 Hz: both 500 samples at 250 Hz


def _export_two(tmp_path, capsys, n=16):
    rng = np.random.default_rng(31)
    rec_dir = tmp_path / 'rawA' / 'PTB-XL' / 'records500' / '00000'
    rec_dir.mkdir(parents=True)
    for ecg_id in range(1, n + 1):
        _write_record(rec_dir, ecg_id, rng.normal(0, 0.4, (12, LEN_A)).astype(np.float32))
    (tmp_path / 'rawB' / 'CODE-test').mkdir(parents=True)
    with h5py.File(tmp_path / 'rawB' / 'CODE-test' / 'ecg_tracings.hdf5', 'w') as f:
        f.create_dataset('tracings', data=rng.normal(0, 0.4, (n, LEN_B, 12)).astype(np.float32))
    for key, raw, out in (('PTB-XL', 'rawA', 'shardsA'), ('CODE-TEST', 'rawB', 'shardsB')):
        cli.main(['export-shards', '--dataset', key, '--data-root', str(tmp_path / raw),
                  '--out', str(tmp_path / out), '--records-per-shard', '8'])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])['shards'] == n // 8
    return str(tmp_path / 'shardsA'), str(tmp_path / 'shardsB')


def _stream_args(dir_a, dir_b):
    return ['pretrain', '--size', 'debug', '--no-bf16', '--batch-size', '8', '--lr', '1e-3',
            '--stream', dir_a, '--stream', dir_b, '--stream-weights', '0.5,0.5',
            '--stream-steps', '12', '--ckpt-every', '4', '--log-every', '4']


# the killed run: the CLI on the CPU, with the test process's thread count,
# sleeping after its first committed checkpoint so the kill lands mid-run
KILLED_RUN = '''
import sys, time, torch
torch.set_num_threads(2)
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.train import trainer
from ecg_representation_learning_tpu_torch.train.pretrain import MaeTrainer
trainer.default_device = lambda device=None: torch.device('cpu')
save = MaeTrainer.save_checkpoint
def slow_save(self, tag='final'):
    path = save(self, tag)
    time.sleep(600)
    return path
MaeTrainer.save_checkpoint = slow_save
cli.main(sys.argv[1:])
'''


def test_cli_stream_pretrain_kill_and_resume_is_bit_identical(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))
    torch.set_num_threads(2)
    dir_a, dir_b = _export_two(tmp_path, capsys)
    base = _stream_args(dir_a, dir_b)
    cli.main(base + ['--output-dir', str(tmp_path / 'full')])
    full = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(full) == {'pretrain_loss', 'steps', 'mix_counts', 'corpora', 'checkpoint'}
    assert full['steps'] == 12 and np.isfinite(full['pretrain_loss'])
    assert full['corpora'] == [2, 2]
    replay = np.random.default_rng(77)          # --seed's default drives the mixture
    draws = [int(replay.choice(2, p=[0.5, 0.5])) for _ in range(12)]
    assert full['mix_counts'] == {str(i): draws.count(i) for i in sorted(set(draws))}

    killed = tmp_path / 'killed'
    proc = subprocess.Popen([sys.executable, '-c', KILLED_RUN] + base
                            + ['--output-dir', str(killed)], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.time() + 240
    try:
        while checkpoint.latest_committed_checkpoint(str(killed)) is None:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.time() < deadline, 'no checkpoint within 4 min'
            time.sleep(0.1)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait()
        proc.stderr.close()
    assert os.path.basename(checkpoint.latest_committed_checkpoint(str(killed))) == 'ckpt-step4'
    cli.main(base + ['--resume', '--output-dir', str(killed)])
    resumed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert resumed['steps'] == 12 and sum(resumed['mix_counts'].values()) == 8
    assert resumed['pretrain_loss'] == full['pretrain_loss']
    a = checkpoint.restore_checkpoint(full['checkpoint'])
    b = checkpoint.restore_checkpoint(resumed['checkpoint'])
    assert os.path.basename(resumed['checkpoint']) == 'ckpt-step12'
    assert a['step'] == b['step'] == 12
    for part in ('params',):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    for part in ('mu', 'nu'):
        assert all(torch.equal(a['opt_state'][part][k], b['opt_state'][part][k])
                   for k in a['opt_state'][part]), part


def test_cli_stream_refuses_contrastive_and_ragged_flags(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))
    with pytest.raises(SystemExit, match='--stream supports --objective mae'):
        cli.main(['pretrain', '--objective', 'contrastive', '--stream', 'shards/'])
    dir_a, dir_b = _export_two(tmp_path, capsys, n=8)
    with pytest.raises(SystemExit, match='--stream-weights: 1 values for 2 corpora'):
        cli.main(['pretrain', '--stream', dir_a, '--stream', dir_b, '--stream-weights', '1'])
    with pytest.raises(SystemExit, match='no shard files found'):
        cli.main(['pretrain', '--stream', str(tmp_path / 'empty*')])


def test_cli_stream_and_export_flags_are_the_jax_names_and_defaults():
    """The stream flags of ``pretrain`` and the flags of ``export`` and
    ``export-shards``: present, with the JAX CLI's defaults and required-ness
    (the whole-parser check is tests/test_torch_train.py's)."""
    from ecg_representation_learning_tpu import cli as jcli
    from test_torch_train import _Parsed, _flags, _subcommands
    import unittest.mock as mock

    def capture(self, *args, **kw):
        raise _Parsed(self)
    with mock.patch.object(jcli.argparse.ArgumentParser, 'parse_args', capture):
        with pytest.raises(_Parsed) as parsed:
            jcli.main([])
    jsub = _subcommands(parsed.value.args[0])
    sub = _subcommands(cli.build_parser())
    stream = {'--stream', '--stream-steps', '--stream-weights', '--stream-raw-fqs',
              '--stream-wire-scale', '--ckpt-every', '--resume', '--log-every'}
    got, want = _flags(sub['pretrain']), _flags(jsub['pretrain'])
    assert {k: got[k] for k in stream} == {k: want[k] for k in stream}
    for name in ('export', 'export-shards'):
        assert _flags(sub[name]) == _flags(jsub[name]), name


# ---------------------------------------------------------------------------
# the torch Dataset adapter
# ---------------------------------------------------------------------------
def test_torch_dataset_items():
    signals, labels, folds = synth_ptbxl(n=32, length=250)
    splits = get_ptbxl_splits(signals, labels, folds)
    ds = as_torch_dataset(splits.train, mean=STATS['mean'], std=STATS['std'],
                          pad_to_multiple=64)
    assert isinstance(ds, torch.utils.data.Dataset)
    item = ds[0]
    assert isinstance(item['sample_values'], torch.Tensor)
    assert item['sample_values'].shape == (12, 256)          # 250 padded up to 256
    assert item['labels'].shape == (71,) and item['labels'].dtype == torch.float32
    batch = next(iter(torch.utils.data.DataLoader(ds, batch_size=4)))
    assert batch['sample_values'].shape == (4, 12, 256)
    full = as_torch_dataset(splits.train, pad_to_multiple=50)[0]['sample_values']
    assert full.shape == (12, 300)                           # a whole extra patch


def test_torch_dataset_matches_the_jax_adapter():
    """Normalized, padded and TimeOut-masked items equal the JAX adapter's
    for the same split and seed; the masked spans are contiguous."""
    signals, labels, folds = jsynth(n=16, length=256)
    splits = jget_splits(signals, labels, folds)
    kw = dict(mean=STATS['mean'], std=STATS['std'], pad_to_multiple=64, timeout=True, seed=3)
    got, want = as_torch_dataset(splits.train, **kw), jadapter.as_torch_dataset(splits.train, **kw)
    assert len(got) == len(want)
    masked = 0
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert torch.equal(g['sample_values'], w['sample_values'])
        assert torch.equal(g['labels'], w['labels'])
        zero_cols = (g['sample_values'].numpy()[:, :256] == 0).all(axis=0)
        if zero_cols.any():
            masked += 1
            assert (np.diff(np.nonzero(zero_cols)[0]) == 1).all()
    assert masked > 0
