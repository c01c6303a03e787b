"""The port's weight-only int8 (models/quantize.py, ``Trainer.enable_int8_inference``)
against the JAX package's.

The same weights go through both quantizers: the set of quantized leaves
(chosen by flax path, so ``pos_embed`` and ``cls_token`` stay f32), the int8
values (the port's are JAX's transposed: a torch ``Linear.weight`` is (out,
in)) and the scales must be equal exactly.  int8 predict is held to the JAX
trainer's int8 predict at the same weights at 1e-5, the bar of
``tests/test_torch_serving.py::test_predict_matches_jax``.
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
from ecg_representation_learning_tpu.models import quantize as jquant
from ecg_representation_learning_tpu.train import trainer as jtrainer
from ecg_representation_learning_tpu_torch import registry
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models import quantize
from ecg_representation_learning_tpu_torch.models.port import (flax_params_from_state_dict,
                                                               flax_path,
                                                               vit_state_dict_from_flax)
from ecg_representation_learning_tpu_torch.models.vit import EcgVit
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)
STATS = registry.PTBXL_TRAIN_STATS['original']


def _signals(seed, n, length=250):
    return (0.2 * np.random.default_rng(seed).standard_normal((n, 12, length))
            ).astype(np.float32)


@pytest.mark.parametrize('size,patch_norm', [('debug', True), ('tiny', False)])
def test_quantized_leaves_values_and_scales_equal_jax(size, patch_norm):
    model = EcgVit(VitConfig.from_defined(size, patch_norm=patch_norm))
    ttrainer.flax_init_(model, 3)
    sd = model.state_dict()
    qweights, scales = quantize.quantize_int8(sd)
    jtree = jax.tree.map(jnp.asarray, flax_params_from_state_dict(sd))
    jq, jscales = jquant.quantize_params_int8(jtree)
    paths = {k: '/'.join(('params',) + flax_path(k)) for k, v in sd.items()}
    assert {paths[k] for k in qweights} == set(jscales)
    assert len(qweights) == 4 * model.cfg.num_hidden_layers + 2   # + patch proj, head
    if size == 'tiny':     # a 3-D leaf >= MIN_QUANT_SIZE that is no kernel stays f32
        assert sd['encoder.pos_embed'].numel() >= quantize.MIN_QUANT_SIZE
        assert 'encoder.pos_embed' not in qweights
    flat = dict(jax.tree_util.tree_flatten_with_path(jq)[0])
    jleaves = {'/'.join(p.key for p in path): leaf for path, leaf in flat.items()}
    for key, q in qweights.items():
        want_q = np.asarray(jleaves[paths[key]])
        assert q.dtype == torch.int8 and want_q.dtype == np.int8
        np.testing.assert_array_equal(q.numpy(), want_q.T)
        np.testing.assert_array_equal(scales[key].numpy(), np.asarray(jscales[paths[key]]).T)
    for key in set(sd) - set(qweights):    # the rest pass through JAX's quantizer as f32
        assert np.asarray(jleaves[paths[key]]).dtype == np.float32


def test_round_trip_error_is_at_most_half_a_step():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32))
    w[7] = 0.0                                   # an all-zero channel: the 1e-12 floor
    q, s = quantize.quantize_int8({'mlp.fc1.weight': w, 'mlp.fc1.bias': torch.zeros(256)})
    assert set(q) == {'mlp.fc1.weight'} and s['mlp.fc1.weight'].shape == (256, 1)
    assert s['mlp.fc1.weight'][7].item() == pytest.approx(1e-12)
    assert q['mlp.fc1.weight'].abs().max().item() == 127
    err = (w - quantize.dequantize(q['mlp.fc1.weight'], s['mlp.fc1.weight'])).abs()
    assert (err <= s['mlp.fc1.weight'] / 2 + 1e-7).all()
    assert quantize.quantized_bytes(q.values()) * 4 == quantize.quantized_bytes([w])


@pytest.fixture(scope='module')
def pair():
    """(JAX Trainer, port Trainer) on one set of weights, both in int8."""
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=320,
                                     use_flash_attention=False)
    jtr = jtrainer.Trainer(jcfg, JaxTrainConfig(eval_batch_size=8, log_to_console=False),
                           norm_stats=jregistry.PTBXL_TRAIN_STATS['original'])
    jtr.init_state()
    params = jax.tree.map(np.asarray, jtr.state.params)
    cfg = VitConfig(**{**dataclasses.asdict(jcfg), 'use_flash_attention': True,
                       'flash_min_seq': 0})
    tr = ttrainer.Trainer(cfg, TrainConfig(eval_batch_size=8, log_to_console=False),
                          norm_stats=STATS, device='cpu')
    tr.set_params(vit_state_dict_from_flax(params, cfg))
    return jtr, tr, jtr.enable_int8_inference(), tr.enable_int8_inference()


def test_int8_predict_matches_jax(pair):
    jtr, tr, jsummary, summary = pair
    assert summary == jsummary and summary['compression'] > 2
    for sig in (_signals(0, 11), _signals(1, 3, 900)):     # a padded batch; windows
        np.testing.assert_allclose(tr.predict_long(sig), jtr.predict_long(sig), atol=1e-5,
                                   rtol=0)


def test_int8_stays_close_to_f32_and_disables(pair):
    _, tr, _, _ = pair
    sig = _signals(2, 8)
    q8 = tr.predict(sig)
    tr.disable_int8_inference()
    try:
        f32 = tr.predict(sig)
        assert 0 < np.abs(q8 - f32).max() < 0.05
        assert np.array_equal(tr.predict(sig), f32)
    finally:
        tr.enable_int8_inference()
    assert np.array_equal(tr.predict(sig), q8)


def test_int8_refreshes_on_set_params_and_load_checkpoint(tmp_path):
    cfg = VitConfig.from_defined('debug', max_signal_length=320)
    tr = ttrainer.Trainer(cfg, TrainConfig(eval_batch_size=8, log_to_console=False,
                                           ema_decay=0.5),
                          norm_stats=STATS, output_dir=str(tmp_path), device='cpu')
    tr.init_state()
    path = tr.save_checkpoint('before')
    sig = _signals(3, 4)
    tr.enable_int8_inference()
    before = tr.predict(sig)
    # the EMA is what int8 serves when it is tracked
    ema_q, _ = quantize.quantize_int8(tr.ema)
    assert all(torch.equal(ema_q[k], v) for k, v in tr._int8['qweights'].items())
    tr.set_params({k: torch.zeros_like(v) for k, v in tr.model.state_dict().items()})
    np.testing.assert_array_equal(tr.predict(sig), np.full_like(before, 0.5))
    tr.load_checkpoint(path)
    np.testing.assert_array_equal(tr.predict(sig), before)
