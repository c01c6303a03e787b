"""The port's MAE model (models/mae.py) against the JAX package's.

Same numpy inputs and the same mask noise (replayed from the JAX mask key:
``random_masking`` draws ``uniform(key, (B, P))``) through both sides, at
the debug width with the small decoder of tests/test_pretrain.py; the JAX
side runs with ``use_flash_attention=False``, as its own tests do on the CPU.
Weights go from flax to the port through ``models.port.state_dict_from_flax``.

Tolerances: patchify, unpatchify and the masking are exact (index
arithmetic and stable sorts); the loss, the reconstruction and the
per-sample losses to rtol 1e-5 (f32 in another operation order), with an
atol of 1e-5 of the array's largest magnitude, since an element near zero
carries the absolute rounding of the sums it came from (measured: 8.5e-6
at most on reconstructions of magnitude ~3); the gradients to rtol 1e-4,
with an atol of 2e-4 of the largest gradient of the same parameter: against
the same function evaluated in f64, the port's f32 gradients are 2.8e-6 of
that scale away and the JAX package's CPU f32 gradients 1.17e-4 (measured
on these inputs), so the JAX side's rounding sets the atol.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import MaeConfig as JaxMaeConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models import mae as jmae
from ecg_representation_learning_tpu_torch.configs import MaeConfig, VitConfig
from ecg_representation_learning_tpu_torch.models import mae
from ecg_representation_learning_tpu_torch.models.port import (
    flax_params_from_state_dict, state_dict_from_flax)
from ecg_representation_learning_tpu_torch.ops.dropout import DropoutRng

torch.set_num_threads(2)
JCFG = JaxVitConfig.from_defined('debug', max_signal_length=320, use_flash_attention=False,
                                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
JMAE = JaxMaeConfig(decoder_hidden_size=64, decoder_num_layers=1, decoder_num_heads=4,
                    decoder_intermediate_size=128)
CFG = VitConfig(**dataclasses.asdict(JCFG))
MAE = MaeConfig(**dataclasses.asdict(JMAE))


def _signals(seed, b=4, length=320):
    return np.random.default_rng(seed).standard_normal((b, 12, length)).astype(np.float32)


@pytest.mark.parametrize('shape,patch', [((2, 12, 320), 64), ((3, 2, 40), 8), ((1, 12, 2560), 64)])
def test_patchify_and_unpatchify_are_exact(shape, patch):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(jmae.patchify(jnp.asarray(x), patch))
    got = mae.patchify(torch.from_numpy(x), patch).numpy()
    np.testing.assert_array_equal(got, want)
    back = mae.unpatchify(torch.from_numpy(want), shape[1], patch).numpy()
    np.testing.assert_array_equal(back, np.asarray(jmae.unpatchify(jnp.asarray(want),
                                                                    shape[1], patch)))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize('ratio', [0.75, 0.5, 0.9, 0.0])
@pytest.mark.parametrize('b,p', [(4, 5), (3, 40)])
def test_random_masking_with_the_same_noise_is_exact(b, p, ratio):
    key = jax.random.PRNGKey(b * 100 + p)
    want = [np.asarray(a) for a in jmae.random_masking(key, b, p, ratio)]
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (b, p))))
    got = [a.numpy() for a in mae.random_masking(b, p, ratio, noise=noise)]
    assert got[0].shape == (b, mae.visible_count(p, ratio))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_random_masking_breaks_ties_by_index_as_jnp_argsort():
    noise = np.array([[0.5, 0.1, 0.5, 0.1, 0.3], [0.2] * 5], np.float32)
    keep, restore, mask = mae.random_masking(2, 5, 0.4, noise=torch.from_numpy(noise))
    shuffle = np.asarray(jnp.argsort(jnp.asarray(noise), axis=1))
    np.testing.assert_array_equal(keep.numpy(), shuffle[:, :3])
    np.testing.assert_array_equal(restore.numpy(), np.argsort(shuffle, axis=1, kind='stable'))
    np.testing.assert_array_equal(mask.numpy().sum(1), [2, 2])


def _jax_mae(jmae_cfg, seed=0):
    model = jmae.EcgMae(JCFG, jmae_cfg)
    x = jnp.zeros((1, 12, JCFG.max_signal_length))
    params = model.init({'params': jax.random.PRNGKey(seed), 'mask': jax.random.PRNGKey(1)}, x)
    return model, jax.tree.map(np.asarray, params)


def _port_mae(params, mae_cfg):
    model = mae.EcgMae(CFG, mae_cfg)
    model.load_state_dict(state_dict_from_flax(params, model))
    return model


def test_weights_round_trip_flax_port_flax_bit_exact():
    _, params = _jax_mae(JMAE)
    model = _port_mae(params, MAE)
    keys = set(model.state_dict())
    assert {'encoder_blocks.0.attn.qkv.weight', 'encoder_pos_embed', 'decoder.mask_token',
            'decoder.blocks.0.mlp.fc1.weight', 'encoder_patch_embed.proj.weight'} <= keys
    back = flax_params_from_state_dict(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize('norm_targets', [True, False])
@pytest.mark.parametrize('mask_ratio', [0.75, 0.4])
def test_mae_forward_matches_jax(norm_targets, mask_ratio):
    jcfg = dataclasses.replace(JMAE, norm_patch_targets=norm_targets, mask_ratio=mask_ratio)
    model_j, params = _jax_mae(jcfg, seed=int(norm_targets))
    model_t = _port_mae(params, MaeConfig(**dataclasses.asdict(jcfg))).eval()
    x = _signals(3)
    key = jax.random.PRNGKey(5)
    want = model_j.apply(params, jnp.asarray(x), mask_rng=key, deterministic=True)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (x.shape[0], 5))))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x), noise=noise)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.ids_restore.numpy(), np.asarray(want.ids_restore))
    for name in ('loss', 'pred', 'per_sample_loss'):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize('norm_targets', [True, False])
def test_mae_gradients_match_jax(norm_targets):
    jcfg = dataclasses.replace(JMAE, norm_patch_targets=norm_targets)
    model_j, params = _jax_mae(jcfg, seed=2)
    model_t = _port_mae(params, MaeConfig(**dataclasses.asdict(jcfg))).train()
    x = _signals(4)
    key = jax.random.PRNGKey(6)
    grads_j = jax.grad(lambda p: model_j.apply(p, jnp.asarray(x), mask_rng=key,
                                               deterministic=True).loss)(params)
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads_j), model_t)
    noise = torch.from_numpy(np.asarray(jax.random.uniform(key, (x.shape[0], 5))))
    model_t(torch.from_numpy(x), noise=noise).loss.backward()
    for name, p in model_t.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=2e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_mask_comes_from_the_device_generator_when_no_noise_is_given():
    model = mae.EcgMae(CFG, MAE).eval()
    x = torch.from_numpy(_signals(5))
    rng = DropoutRng(host=torch.Generator(), device=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a = model(x, rng=rng)
        noise = torch.rand((x.shape[0], 5), generator=torch.Generator().manual_seed(3))
        b = model(x, noise=noise)
    assert torch.equal(a.mask, b.mask) and torch.equal(a.loss, b.loss)
    with pytest.raises(ValueError, match='noise'):
        model(x)


def test_moe_raises():
    # MoE builds (tests/test_torch_moe.py holds it to JAX): the encoder blocks
    # follow the trunk's placement rule, the decoder stays dense
    model = mae.EcgMae(dataclasses.replace(CFG, moe_num_experts=4), MAE)
    assert [hasattr(b, 'moe') for b in model.encoder_blocks] == [False, True, False, True]
    assert not any(hasattr(b, 'moe') for b in model.decoder.blocks)
    # context parallelism stays refused
    with pytest.raises(NotImplementedError, match='ring_axis'):
        mae.EcgMae(dataclasses.replace(CFG, ring_axis='seq'), MAE)
