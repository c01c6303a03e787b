"""The port's ViT (models/vit.py, models/port.py) against the JAX package's.

A JAX ``create_vit`` init is carried into the port with
``vit_state_dict_from_flax``; both run the same numpy batch.  The JAX side
reaches its Pallas flash kernel in interpret mode (``flash_min_seq=0``) or
its XLA attention (128); the port, on the same config, runs the flash
kernel's plain version at 0 and plain attention at 128.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models import vit as jvit
from ecg_representation_learning_tpu_torch.configs import VitConfig
from ecg_representation_learning_tpu_torch.models import vit as tvit
from ecg_representation_learning_tpu_torch.models.port import (
    flax_params_from_vit_state_dict, vit_state_dict_from_flax)

torch.set_num_threads(2)


def _pair(seed=0, **overrides):
    """(JAX logits fn, port model) sharing one JAX init of the debug ViT."""
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=320,
                                     flash_interpret=True, **overrides)
    model, params = jvit.create_vit(jcfg, jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    tm = tvit.EcgVit(cfg).eval()
    tm.load_state_dict(vit_state_dict_from_flax(params, cfg))
    return (lambda x: np.asarray(model.apply(params, jnp.asarray(x)).logits)), tm, params


def _batch(seed=0, n=4, length=320):
    return np.random.default_rng(seed).standard_normal((n, 12, length)).astype(np.float32)


@pytest.mark.parametrize('flash_min_seq', [0, 128])
@pytest.mark.parametrize('pool', ['cls', 'mean'])
@pytest.mark.parametrize('patch_norm', [True, False])
def test_logits_match_jax_f32(patch_norm, pool, flash_min_seq):
    jax_logits, tm, _ = _pair(patch_norm=patch_norm, pool=pool,
                              flash_min_seq=flash_min_seq)
    x = _batch()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).logits.numpy()
    want = jax_logits(x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('flash_min_seq', [0, 128])
def test_logits_match_jax_bf16(flash_min_seq):
    # bf16 keeps 8 significant bits (eps 2^-8 = 3.9e-3).  The two frameworks
    # round at different places (torch adds the bias inside the bf16 matmul,
    # flax after rounding it; GELU and the residual adds round separately),
    # and the differences compound over 4 blocks: measured 2.0e-2 on logits
    # of magnitude ~2.7, so the bar is 5e-2.
    jax_logits, tm, _ = _pair(dtype='bfloat16', flash_min_seq=flash_min_seq)
    x = _batch(1)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, jax_logits(x), atol=5e-2, rtol=0)


def test_shorter_input_uses_leading_positions():
    # a 256-sample batch has 4 patches + cls: pos_embed[:, :5] on both sides
    jax_logits, tm, _ = _pair(flash_min_seq=0)
    x = _batch(2, length=256)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, jax_logits(x), atol=1e-4, rtol=0)


@pytest.mark.parametrize('reduction', ['mean', 'none'])
@pytest.mark.parametrize('weight', [None, (0.3, 2.0)])
def test_bce_with_logits_matches_jax(weight, reduction):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((8, 71)) * 3).astype(np.float32)
    labels = (rng.random((8, 71)) < 0.3).astype(np.float32)
    want = np.asarray(jvit.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                           reduction, weight))
    got = tvit.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                               reduction, weight).numpy()
    # log1p/exp come from different math libraries (XLA's vs torch's) and the
    # means sum in another order: equal to a few f32 ulps, not bit for bit
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_bce_rejects_unknown_reduction():
    with pytest.raises(ValueError, match='reduction'):
        tvit.bce_with_logits(torch.zeros(2, 3), torch.zeros(2, 3), 'sum')


@pytest.mark.parametrize('size', ['debug', 'tiny', 'small', 'base', 'large'])
def test_forward_flops_per_sample_equal(size):
    assert (tvit.forward_flops_per_sample(VitConfig.from_defined(size))
            == jvit.forward_flops_per_sample(JaxVitConfig.from_defined(size)))


@pytest.mark.parametrize('patch_norm', [True, False])
def test_weights_round_trip_flax_torch_flax_bit_exact(patch_norm):
    _, tm, params = _pair(patch_norm=patch_norm)
    back = flax_params_from_vit_state_dict(tm.state_dict())
    want = jax.tree_util.tree_flatten_with_path(params)
    got = jax.tree_util.tree_flatten_with_path(back)
    assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
    for (path, a), (_, b) in zip(got[0], want[0]):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_port_mapping_rejects_partial_or_misshapen_params():
    _, tm, params = _pair()
    cfg = tm.cfg
    tree = jax.tree.map(lambda a: a, params)
    del tree['params']['encoder']['block_3']
    with pytest.raises(KeyError, match='lack'):
        vit_state_dict_from_flax(tree, cfg)
    tree = jax.tree.map(lambda a: a, params)
    tree['params']['head']['kernel'] = np.zeros((64, 70), np.float32)
    with pytest.raises(ValueError, match='head.weight'):
        vit_state_dict_from_flax(tree, cfg)


def test_model_rejects_unported_features():
    with pytest.raises(NotImplementedError, match='moe_num_experts'):
        tvit.EcgVit(VitConfig.from_defined('debug', moe_num_experts=4))
    # remat would redraw the dropout seeds on recompute: it stays unported
    with pytest.raises(NotImplementedError, match='remat'):
        tvit.EcgVit(VitConfig.from_defined('debug', remat=True))
    # the training forward runs, but a dropout site needs its generators
    m = tvit.EcgVit(VitConfig.from_defined('debug', max_signal_length=320))
    with pytest.raises(ValueError, match='rng'):
        m.train()(torch.zeros(1, 12, 320))
