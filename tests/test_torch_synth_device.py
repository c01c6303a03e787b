"""The port's ``synth_ptbxl_device`` against the JAX package's, and the
trainer on a split whose signals are a tensor.

Labels and folds come from the same host draws and must be equal.  The two
white-noise fields are drawn from a device ``torch.Generator`` in the port
and from ``jax.random`` in JAX, so the signals are compared with JAX's
fields replayed into the port (``noise=``).  Tolerance: 3e-4 abs.  The
marker tones take ``sin`` of arguments up to 2*pi*21.9 Hz*10 s = 1,376 rad,
where one f32 ulp is 1.2e-4: XLA and PyTorch round the argument's product
and sum in their own way (and their ``sin`` differ in the last bits), so a
tone of amplitude up to ~1.5 moves by ~1e-4, and up to a few tones overlap;
measured 1.7e-4 at most and 1.5e-6 on average (the mean is held at 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.data import synth_ptbxl_device as jax_synth
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.data import (get_ptbxl_splits, synth_ptbxl,
                                                        synth_ptbxl_device)
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer

ATOL, MEAN_ATOL = 3e-4, 1e-5


def jax_noise(n, length, chunk, seed=77):
    """The two standard normal fields JAX's generator draws, chunk by chunk
    (its tail chunk padded to ``chunk`` rows), as (n, 12, L) tensors."""
    key = jax.random.PRNGKey(seed)
    white, marker = [], []
    for lo in range(0, n, chunk):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        rows = min(chunk, n - lo)
        white.append(np.asarray(jax.random.normal(k1, (chunk, 12, length), jnp.float32))[:rows])
        marker.append(np.asarray(jax.random.normal(k2, (chunk, 12, length), jnp.float32))[:rows])
    return torch.from_numpy(np.concatenate(white)), torch.from_numpy(np.concatenate(marker))


@pytest.mark.parametrize('n,length,k,chunk', [(100, 2500, 16, 64), (64, 256, 4, 64),
                                              (37, 500, 8, 16)])
def test_signals_labels_and_folds_match_jax(n, length, k, chunk):
    want, jlabels, jfolds = jax_synth(n=n, length=length, n_marker_classes=k, chunk=chunk)
    got, labels, folds = synth_ptbxl_device(n=n, length=length, n_marker_classes=k,
                                            chunk=chunk, device='cpu',
                                            noise=jax_noise(n, length, chunk))
    assert labels == jlabels
    np.testing.assert_array_equal(folds, jfolds)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, 12, length)
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= ATOL and diff.mean() <= MEAN_ATOL, (diff.max(), diff.mean())


def test_generator_shapes_and_distribution():
    """tests/test_synth_device.py's checks on the port's generator."""
    sig, labels, folds = synth_ptbxl_device(n=200, length=500, n_marker_classes=8,
                                            chunk=128, device='cpu')
    assert isinstance(sig, torch.Tensor) and tuple(sig.shape) == (200, 12, 500)
    arr = sig.numpy()
    assert np.isfinite(arr).all()
    host, _, _ = synth_ptbxl(n=200, length=500, n_marker_classes=8, hard=True)
    assert abs(arr.std() - host.std()) / host.std() < 0.3
    assert len(labels) == 200 and folds.shape == (200,)
    assert all(1 <= f <= 10 for f in folds)
    counts = np.zeros(9)
    for lbs in labels:
        for i in lbs:
            counts[min(i, 8)] += 1
    assert counts[0] > counts[7]                 # long-tailed prevalence


def test_deterministic_in_seed_and_noise_from_the_generator():
    a, la, fa = synth_ptbxl_device(n=64, length=256, n_marker_classes=4, chunk=64,
                                   device='cpu')
    b, lb, fb = synth_ptbxl_device(n=64, length=256, n_marker_classes=4, chunk=64,
                                   device='cpu')
    assert torch.equal(a, b) and la == lb and (fa == fb).all()
    c, lc, _ = synth_ptbxl_device(n=64, length=256, n_marker_classes=4, chunk=64,
                                  seed=78, device='cpu')
    assert not torch.equal(a, c)
    # replaying the generator's own fields gives the same bits
    gen = torch.Generator().manual_seed(77)
    white = torch.randn((64, 12, 256), generator=gen)
    marker = torch.randn((64, 12, 256), generator=gen)
    d, _, _ = synth_ptbxl_device(n=64, length=256, n_marker_classes=4, chunk=64,
                                 device='cpu', noise=(white, marker))
    assert torch.equal(a, d)


def test_tail_chunk():
    sig, labels, folds = synth_ptbxl_device(n=100, length=256, n_marker_classes=4,
                                            chunk=64, device='cpu')
    assert tuple(sig.shape) == (100, 12, 256) and torch.isfinite(sig).all()
    assert len(labels) == 100 and folds.shape == (100,)


@pytest.fixture
def no_numpy_round_trip(monkeypatch):
    """``np.asarray`` refuses torch tensors: a split whose signals are a
    tensor (on the GPU, numpy cannot read them) must move with ``.to``."""
    real = np.asarray

    def guarded(a, *args, **kw):
        if isinstance(a, torch.Tensor):
            raise AssertionError('a tensor split was copied through numpy')
        return real(a, *args, **kw)
    monkeypatch.setattr(np, 'asarray', guarded)


@pytest.mark.parametrize('resident', [True, False])
def test_trainer_takes_a_tensor_split(no_numpy_round_trip, resident):
    """The device corpus feeds the trainer without a copy through numpy;
    a step on it equals the step on the same rows as a numpy split."""
    sig, labels, folds = synth_ptbxl_device(n=160, length=640, n_marker_classes=8,
                                            chunk=160, device='cpu')
    splits = get_ptbxl_splits(sig, labels, folds)
    assert isinstance(splits.train.signals, torch.Tensor)
    host = SplitData(signals=splits.train.signals.numpy().copy(), labels=splits.train.labels)
    cfg = VitConfig.from_defined('debug', max_signal_length=704, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
    losses, params = [], []
    for data in (splits.train, host):
        tr = Trainer(cfg, TrainConfig(train_batch_size=16, eval_batch_size=32,
                                      log_to_console=False, device_resident=resident),
                     device='cpu')
        tr.init_state()
        losses.append(float(tr.train_step(data, np.arange(3, 19))['loss']))
        params.append(tr.model.state_dict())
        assert bool(tr._resident) == resident
        if resident:
            assert tr._split_arrays(data)[0].dtype == torch.float32
        assert np.isfinite(tr.evaluate(splits.eval)['loss'])
    assert losses[0] == losses[1]
    assert all(torch.equal(params[0][k], params[1][k]) for k in params[0])
