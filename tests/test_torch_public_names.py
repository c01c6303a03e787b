"""The last public names of the JAX package, held against their JAX twins.

  * ``models.create_vit``: the port's flax-style init from an explicit
    ``torch.Generator`` has JAX's shapes and distributions leaf for leaf
    (lecun-normal kernels truncated at 2 std with variance 1 / fan-in, zero
    biases, unit LayerNorm scales, normal(0.02) tokens and position
    embeddings), checked as ``tests/test_torch_serving.py`` checks the
    trainer's init; the same generator state gives the same weights;
  * ``models.param_count``: equal on ViT-base (the JAX tree by
    ``jax.eval_shape``, the port's module on the meta device);
  * ``models.vit.forward_flops_per_sample`` and
    ``train_step_flops_per_sample``: equal for every size;
  * ``registry.PTBXL_BROKEN_RECORD_ROW`` / ``_LEAD``: equal;
  * ``train.optim.adam_moments``: after one step from the same weights and
    gradients, the moments of both optimizer layouts (``FusedAdamW`` and the
    optax chain, ``AdamChain`` in the port) equal JAX's at rtol 2e-5, atol
    1e-7 (the bar of ``tests/test_torch_optim.py`` for one FusedAdamW step);
  * ``train.get_all_setup``: the same model and train configs as JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu import registry as jregistry
from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models import vit as jvit
from ecg_representation_learning_tpu.train import get_all_setup as jax_get_all_setup
from ecg_representation_learning_tpu.train import optim as joptim
from ecg_representation_learning_tpu_torch import models, registry, train
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models import vit as tvit
from ecg_representation_learning_tpu_torch.models.port import (flax_params_from_state_dict,
                                                               vit_state_dict_from_flax)
from ecg_representation_learning_tpu_torch.train import optim as toptim

torch.set_num_threads(2)
SIZES = ['debug', 'tiny', 'small', 'base', 'large']


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_create_vit_has_the_jax_init_distributions():
    cfg = JaxVitConfig.from_defined('tiny')
    _, jparams = jvit.create_vit(cfg, jax.random.PRNGKey(0))
    model, sd = models.create_vit(VitConfig(**dataclasses.asdict(cfg)),
                                  torch.Generator().manual_seed(0))
    assert isinstance(model, models.EcgVit) and not model.training
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    want = dict(_leaves(jparams['params']))
    got = dict(_leaves(flax_params_from_state_dict(sd)['params']))
    assert {p: a.shape for p, a in got.items()} == {p: a.shape for p, a in want.items()}
    for path, w in want.items():
        g = got[path]
        if path[-1] in ('bias', 'scale') or not w.any():
            np.testing.assert_array_equal(g, w, err_msg=str(path))   # zeros, ones
            continue
        if path[-1] == 'kernel':      # lecun normal, truncated at 2 std
            bound = 2 * w.shape[-2] ** -0.5 / 0.87962566103423978
            assert np.abs(g).max() <= bound + 1e-6 and np.abs(w).max() <= bound + 1e-6, path
        # the same distribution: each side's std within 10 % of the other's
        assert abs(g.std() / w.std() - 1) < 0.1, (path, g.std(), w.std())
    assert abs(sd['encoder.pos_embed'].std().item() - 0.02) < 0.002
    _, again = models.create_vit(VitConfig(**dataclasses.asdict(cfg)),
                                 torch.Generator().manual_seed(0))
    _, other = models.create_vit(VitConfig(**dataclasses.asdict(cfg)),
                                 torch.Generator().manual_seed(1))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd['head.weight'], other['head.weight'])


def test_create_vit_refuses_a_length_the_model_cannot_take():
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=320)
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    _, sd = models.create_vit(cfg, torch.Generator().manual_seed(0), signal_length=256)
    _, jparams = jvit.create_vit(jcfg, jax.random.PRNGKey(0), signal_length=256)
    assert sd['encoder.pos_embed'].shape == jparams['params']['encoder']['pos_embed'].shape
    with pytest.raises(Exception):
        jvit.create_vit(jcfg, jax.random.PRNGKey(0), signal_length=4096)
    with pytest.raises(Exception):
        models.create_vit(cfg, torch.Generator().manual_seed(0), signal_length=4096)


def test_param_count_equals_jax_on_vit_base():
    cfg = JaxVitConfig.from_defined('base')
    shapes = jax.eval_shape(lambda k: jvit.create_vit(cfg, k)[1], jax.random.PRNGKey(0))
    with torch.device('meta'):
        model = models.EcgVit(VitConfig.from_defined('base'))
    want = jvit.param_count(shapes)
    assert models.param_count(model) == models.param_count(model.state_dict()) == want
    assert want > 85_000_000


@pytest.mark.parametrize('size', SIZES)
def test_flops_per_sample_equal_jax(size):
    jcfg, cfg = JaxVitConfig.from_defined(size), VitConfig.from_defined(size)
    assert tvit.forward_flops_per_sample(cfg) == jvit.forward_flops_per_sample(jcfg)
    assert tvit.train_step_flops_per_sample(cfg) == jvit.train_step_flops_per_sample(jcfg)
    assert models.train_step_flops_per_sample(cfg) == 3 * tvit.forward_flops_per_sample(cfg)


def test_broken_record_constants_equal_jax():
    assert registry.PTBXL_BROKEN_RECORD_ROW == jregistry.PTBXL_BROKEN_RECORD_ROW == 12721
    assert registry.PTBXL_BROKEN_RECORD_LEAD == jregistry.PTBXL_BROKEN_RECORD_LEAD


@pytest.mark.parametrize('fused', [True, False])
def test_adam_moments_equal_jax_after_one_step(fused):
    cfg = VitConfig.from_defined('debug', max_signal_length=320)
    _, sd = models.create_vit(cfg, torch.Generator().manual_seed(4))
    flax = flax_params_from_state_dict(sd)
    rng = np.random.default_rng(4)
    gflax = jax.tree.map(lambda a: (1e-2 * rng.standard_normal(a.shape)).astype(np.float32),
                         flax)
    kw = dict(fused_optimizer=fused, grad_clip_norm=1.0, learning_rate=1e-3)
    jopt, _ = joptim.make_optimizer(JaxTrainConfig(**kw), 10)
    jparams = jax.tree.map(jnp.asarray, flax)
    jstate = jopt.init(jparams)
    _, jstate = joptim.apply_optimizer(jopt, jax.tree.map(jnp.asarray, gflax), jstate, jparams)
    jmu, jnu = joptim.adam_moments(jstate)
    opt, _ = toptim.make_optimizer(TrainConfig(**kw), 10)
    assert isinstance(opt, toptim.FusedAdamW if fused else toptim.AdamChain)
    params = {k: v.clone() for k, v in sd.items()}
    state = opt.init(params)
    state = opt.apply(vit_state_dict_from_flax(gflax, cfg), state, params)
    mu, nu = toptim.adam_moments(state)
    assert mu is state.mu and nu is state.nu
    for got, want in ((mu, jmu), (nu, jnu)):
        want = vit_state_dict_from_flax(jax.tree.map(np.asarray, want), cfg)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-5, atol=1e-7,
                                       err_msg=k)


def test_get_all_setup_builds_the_jax_configs():
    args = {'num_train_epoch': 2, 'ema_decay': 0.5, 'train_batch_size': 16}
    jtr = jax_get_all_setup('small', args)
    tr = train.get_all_setup('small', args, device='cpu')
    assert isinstance(tr, train.Trainer)
    assert dataclasses.asdict(tr.model_cfg) == dataclasses.asdict(jtr.model_cfg)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(jtr.cfg)
    assert tr.model_cfg == VitConfig.from_defined('ecg-vit-small')
