"""Asynchronous checkpoints of the port (train/checkpoint.py,
``TrainConfig.async_checkpoint``): the cases of tests/test_async_checkpoint.py
on the port's one-file format.

A save copies the state to the host on the caller's thread and writes it on
the writer thread; a restore waits for a save in flight and gives its bits;
a trainer with async saves resumes to the same eval loss (rtol 1e-6, the JAX
test's bar); a save killed midway leaves only its tmp directory, which the
listings skip; pruning keeps the newest step tags.  The JAX test of its
orbax ``.meta.json`` sidecar has no counterpart (the port keeps the epoch in
the one state file); in its place, a write that fails on the thread raises
at the next wait or save.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits, synth_ptbxl
from ecg_representation_learning_tpu_torch.train import Trainer, checkpoint

torch.set_num_threads(2)


def small_trainer(tmp_path, tag, **cfg_kw):
    signals, labels, folds = synth_ptbxl(n=96, length=256)
    splits = get_ptbxl_splits(signals, labels, folds)
    cfg = VitConfig.from_defined('debug', max_signal_length=320, use_flash_attention=False)
    tcfg = TrainConfig(num_train_epoch=2, train_batch_size=16, eval_batch_size=32,
                       do_eval=False, log_to_console=False, **cfg_kw)
    tr = Trainer(cfg, tcfg, train_data=splits.train, eval_data=splits.eval,
                 output_dir=str(tmp_path / tag), device='cpu')
    return tr, splits


def _state(tr):
    return {'params': tr.model.state_dict(),
            'opt_state': {'count': tr.opt_state.count, 'mu': tr.opt_state.mu,
                          'nu': tr.opt_state.nu},
            'epoch': 3}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture
def held_writes(monkeypatch):
    """Writer-thread saves block in ``torch.save`` until ``release`` is set
    (at most 60 s)."""
    release = threading.Event()
    save = torch.save

    def held(obj, f):
        if threading.current_thread() is not threading.main_thread():
            release.wait(60)
        save(obj, f)
    monkeypatch.setattr(checkpoint.torch, 'save', held)
    yield release
    release.set()
    checkpoint.wait_for_checkpoints()


def test_async_save_restores_bit_exact(tmp_path, held_writes):
    tr, _ = small_trainer(tmp_path, 'sync')
    tr.init_state()
    want = {k: v.clone() for k, v in tr.model.state_dict().items()}
    path = str(tmp_path / 'ckpt-async')
    checkpoint.save_checkpoint(path, _state(tr), async_save=True)
    # the snapshot was taken on this thread: later updates are not saved
    with torch.no_grad():
        for p in tr.model.parameters():
            p.add_(1.0)
    assert not os.path.exists(path)                  # the write is held
    threading.Timer(0.2, held_writes.set).start()
    restored = checkpoint.restore_checkpoint(path)   # waits for the write
    assert restored['epoch'] == 3
    _equal(restored['params'], want)
    _equal(restored['opt_state'], {'count': tr.opt_state.count, 'mu': tr.opt_state.mu,
                                   'nu': tr.opt_state.nu})
    checkpoint.wait_for_checkpoints()               # idempotent


def test_one_save_in_flight_at_a_time(tmp_path, held_writes):
    tr, _ = small_trainer(tmp_path, 'two')
    tr.init_state()
    first = str(tmp_path / 'ckpt-a')
    checkpoint.save_checkpoint(first, _state(tr), async_save=True)
    threading.Timer(0.2, held_writes.set).start()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(str(tmp_path / 'ckpt-b'), _state(tr), async_save=True)
    assert time.perf_counter() - t0 >= 0.15           # waited for the first
    assert os.path.isfile(os.path.join(first, checkpoint.STATE_FILE))
    checkpoint.wait_for_checkpoints()
    assert [os.path.basename(p) for p in checkpoint.committed_checkpoints(str(tmp_path))] \
        in (['ckpt-a', 'ckpt-b'], ['ckpt-b', 'ckpt-a'])


def test_trainer_async_checkpoint_resume_parity(tmp_path):
    tr, splits = small_trainer(tmp_path, 'a', async_checkpoint=True, save_every_n_epoch=1)
    res = tr.train()
    # train() returns with every save committed
    assert res['epochs'] == 2
    for tag in ('ep1', 'ep2', 'final'):
        assert os.path.isfile(tmp_path / 'a' / f'ckpt-{tag}' / checkpoint.STATE_FILE)
    tr2, _ = small_trainer(tmp_path, 'b')
    tr2.load_checkpoint(str(tmp_path / 'a' / 'ckpt-final'))
    ev_a = tr.evaluate(splits.eval)['loss']
    ev_b = tr2.evaluate(splits.eval)['loss']
    np.testing.assert_allclose(ev_a, ev_b, rtol=1e-6)
    assert tr2.step == tr.step and tr2.epoch == 2


def test_latest_committed_skips_tmp_dirs(tmp_path):
    """A kill mid-save leaves a ``.tmp-<pid>`` sibling; the crash-recovery
    resume picks the last committed checkpoint (ckpt-step{N} ordered by
    step, not mtime)."""
    d = tmp_path / 'out'
    for name in ('ckpt-step10', 'ckpt-step20', 'ckpt-step30.tmp-1234567'):
        (d / name).mkdir(parents=True)
        (d / name / checkpoint.STATE_FILE).write_bytes(b'')
        time.sleep(0.01)
    assert checkpoint.latest_committed_checkpoint(str(d)) == str(d / 'ckpt-step20')
    os.utime(d / 'ckpt-step10')
    assert checkpoint.latest_committed_checkpoint(str(d)) == str(d / 'ckpt-step20')


def test_a_killed_async_write_leaves_only_its_tmp_dir(tmp_path, monkeypatch):
    """The writer dies after part of the file: the final name never appears,
    the tmp directory is skipped by the listings, and the next wait raises."""
    def killed(obj, f):
        with open(f, 'wb') as fh:
            fh.write(b'partial')
        raise OSError('writer killed')
    tr, _ = small_trainer(tmp_path, 'k')
    tr.init_state()
    d = tmp_path / 'out'
    checkpoint.save_checkpoint(str(d / 'ckpt-step1'), _state(tr))
    monkeypatch.setattr(checkpoint.torch, 'save', killed)
    checkpoint.save_checkpoint(str(d / 'ckpt-step2'), _state(tr), async_save=True)
    with pytest.raises(RuntimeError, match='writer killed'):
        checkpoint.wait_for_checkpoints()
    assert sorted(os.listdir(d)) == ['ckpt-step1', f'ckpt-step2.tmp-{os.getpid()}']
    assert checkpoint.latest_committed_checkpoint(str(d)) == str(d / 'ckpt-step1')


def test_prune_keeps_newest_step_tags_only(tmp_path):
    d = tmp_path / 'out'
    for name in ('ckpt-step2', 'ckpt-step4', 'ckpt-step10', 'ckpt-best', 'ckpt-final',
                 'ckpt-step12.tmp-99'):
        (d / name).mkdir(parents=True)
        (d / name / checkpoint.STATE_FILE).write_bytes(b'')
    checkpoint.prune_checkpoints(str(d), keep=2)
    assert sorted(os.listdir(d)) == ['ckpt-best', 'ckpt-final', 'ckpt-step10',
                                     'ckpt-step12.tmp-99', 'ckpt-step4']
    assert checkpoint.latest_committed_checkpoint(str(d)) == str(d / 'ckpt-step10')
    assert [os.path.basename(p) for p in checkpoint.committed_checkpoints(str(d))][-2:] == \
        ['ckpt-step4', 'ckpt-step10']
    checkpoint.prune_checkpoints(str(d), keep=0)
    assert sorted(p for p in os.listdir(d) if 'tmp' not in p) == ['ckpt-best', 'ckpt-final']


@pytest.mark.parametrize('next_call', ['wait', 'save'])
def test_a_failed_write_raises_at_the_next_wait_or_save(tmp_path, monkeypatch, next_call):
    tr, _ = small_trainer(tmp_path, 'f')
    tr.init_state()
    save, failed = torch.save, []

    def fail_once(obj, f):
        if not failed:
            failed.append(f)
            raise OSError('disk full')
        save(obj, f)
    monkeypatch.setattr(checkpoint.torch, 'save', fail_once)
    checkpoint.save_checkpoint(str(tmp_path / 'ckpt-bad'), _state(tr), async_save=True)
    with pytest.raises(RuntimeError, match='disk full'):
        if next_call == 'wait':
            checkpoint.wait_for_checkpoints()
        else:
            checkpoint.save_checkpoint(str(tmp_path / 'ckpt-next'), _state(tr))
    checkpoint.wait_for_checkpoints()              # raised once, then clear
    assert not os.path.exists(tmp_path / 'ckpt-bad')
    path = checkpoint.save_checkpoint(str(tmp_path / 'ckpt-good'), _state(tr),
                                      async_save=True)
    assert checkpoint.restore_checkpoint(path)['epoch'] == 3
