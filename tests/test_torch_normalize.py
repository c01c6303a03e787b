"""The port's ops/normalize.py against the JAX package's ops/normalize.

The cases of tests/test_ops_transform.py:13-46 on both sides with the same
numpy inputs: the fitted statistics are the same numpy computation (equal),
the transforms f32 elementwise ops (rtol 1e-6: a division against XLA's,
which may take a reciprocal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.ops import normalize as jnorm
from ecg_representation_learning_tpu_torch.ops import normalize
from ecg_representation_learning_tpu_torch.registry import PTBXL_TRAIN_STATS
from ecg_representation_learning_tpu_torch.train.trainer import _prep_batch


def _both(fn_j, fn_t, x):
    return (np.asarray(fn_j(jnp.asarray(x))), fn_t(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize('stats', ['original', 'denoised'])
def test_normalize_fixed_stats(stats):
    x = np.random.default_rng(0).standard_normal((4, 12, 100)).astype(np.float32)
    st = PTBXL_TRAIN_STATS[stats]
    want, got = _both(lambda a: jnorm.normalize_fixed(a, st['mean'], st['std']),
                      lambda a: normalize.normalize_fixed(a, st['mean'], st['std']), x)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    mean = np.asarray(st['mean']).reshape((1, 12, 1))
    np.testing.assert_allclose(got, (x - mean) / np.asarray(st['std']).reshape((1, 12, 1)),
                               rtol=1e-5)


@pytest.mark.parametrize('schemes,shape', [
    (('std', 1), (8, 12, 50)), ('global', (4, 2, 30)), ([('norm', 3), ('std', 1)], (6, 3, 40)),
    ('none', (2, 3, 10)), ('norm', (5, 4, 60)), ([('std', 2), 'global'], (3, 12, 25))])
def test_dynamic_norm_matches_jax(schemes, shape):
    arr = np.random.default_rng(sum(shape)).standard_normal(shape) * 3 + 2
    want = jnorm.fit_dynamic_norm(arr, schemes)
    got = normalize.fit_dynamic_norm(arr, schemes)
    assert [(g.sub, g.div) for g in got] == [(w.sub, w.div) for w in want]
    x = arr.astype(np.float32)
    out_j, out_t = _both(lambda a: jnorm.apply_norms(a, want),
                         lambda a: normalize.apply_norms(a, got), x)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-6)


def test_dynamic_norm_std_scheme_centres_and_scales():
    arr = np.random.default_rng(1).standard_normal((8, 12, 50)) * 3 + 2
    out = normalize.apply_norms(torch.from_numpy(arr.astype(np.float32)),
                                normalize.fit_dynamic_norm(arr, ('std', 1))).numpy()
    np.testing.assert_allclose(out.mean(axis=(0, 2)), 0, atol=1e-2)
    np.testing.assert_allclose(out.std(axis=(0, 2)), 1, atol=1e-2)


def test_dynamic_norm_global_scheme_maps_into_unit_range():
    arr = np.random.default_rng(2).standard_normal((4, 2, 30))
    out = normalize.apply_norms(torch.from_numpy(arr.astype(np.float32)),
                                normalize.fit_dynamic_norm(arr, 'global')).numpy()
    assert out.min() >= -1e-6 and out.max() <= 1 + 1e-6


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match='Unknown'):
        normalize.fit_dynamic_norm(np.zeros((2, 3, 4)), 'minmax')


def test_prep_batch_normalizes_with_normalize_fixed():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 12, 100)).astype(np.float32))
    st = PTBXL_TRAIN_STATS['original']
    mean, std = torch.tensor(st['mean']), torch.tensor(st['std'])
    got = _prep_batch(x, mean, std, 64)
    assert got.shape == (2, 12, 128)
    assert torch.equal(got[..., :100], normalize.normalize_fixed(x, st['mean'], st['std']))
    assert (got[..., 100:] == 0).all()
