"""The port's attention rollout and visualizers (utils/rollout.py, utils/viz.py,
``cli visualize``) on the CPU, against the JAX package.

``attention_rollout`` and ``top_predictions`` are the JAX package's numpy
code: held equal on the same inputs (rollout at 1e-12; selections exactly).
The maps ``EcgVitVisualizer`` reads come from the port's ``return_attention``
forward: on JAX's weights (carried over through ``models/port``) they and
their rollout are held to JAX's at 1e-5, the model-parity bar of
``tests/test_torch_vit.py``.  The figures render with the Agg backend.
"""
import dataclasses
import json
import os

import matplotlib
matplotlib.use('Agg')

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models import create_vit
from ecg_representation_learning_tpu.utils import rollout as jrollout
from ecg_representation_learning_tpu_torch import cli, utils
from ecg_representation_learning_tpu_torch.configs import VitConfig
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits, synth_ptbxl
from ecg_representation_learning_tpu_torch.models.port import vit_state_dict_from_flax
from ecg_representation_learning_tpu_torch.models.vit import EcgVit
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer
from ecg_representation_learning_tpu_torch.utils import (EcgVitVisualizer, attention_rollout,
                                                         top_predictions)

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def models():
    """(JAX model, its params, the port's EcgVit with those weights)."""
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=640,
                                     use_flash_attention=False)
    jmodel, params = create_vit(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    model = EcgVit(cfg).eval()
    model.load_state_dict(vit_state_dict_from_flax(params['params'], cfg))
    return jmodel, params, model


@pytest.mark.parametrize('shape', [(3, 2, 5, 5), (4, 1, 4, 11, 11)])
def test_attention_rollout_matches_jax(shape, rng):
    attn = rng.uniform(size=shape)
    attn = attn / attn.sum(-1, keepdims=True)
    np.testing.assert_allclose(attention_rollout(attn), jrollout.attention_rollout(attn),
                               atol=1e-12, rtol=0)
    t = shape[-1]
    eye = np.broadcast_to(np.eye(t), (3, 2, t, t))
    s2 = attention_rollout(eye)
    assert np.isfinite(s2).all() and s2.max() == 0.0
    np.testing.assert_array_equal(s2, jrollout.attention_rollout(eye))


@pytest.mark.parametrize('seed', range(4))
def test_top_predictions_match_jax(seed):
    r = np.random.default_rng(seed)
    probs = r.uniform(size=71) ** 3
    labels = (r.uniform(size=71) < 0.05).astype(np.float32)
    got = top_predictions(probs, labels)
    assert got == jrollout.top_predictions(probs, labels)
    assert all(isinstance(c, bool) for c in got[2])


def test_return_attention_maps_and_rollout_match_jax(models, rng):
    jmodel, params, model = models
    sig = rng.standard_normal((1, 12, 640)).astype(np.float32)
    jout = jmodel.apply(params, jnp.asarray(sig), return_attention=True)
    with torch.no_grad():
        out = model(torch.from_numpy(sig), return_attention=True)
    want = np.asarray(jout.attention)
    assert out.attention.shape == want.shape == (4, 1, 4, 11, 11)
    np.testing.assert_allclose(out.attention.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(attention_rollout(out.attention.numpy()),
                               jrollout.attention_rollout(want), atol=1e-5, rtol=0)


def test_visualizer_renders(models, tmp_path, rng, monkeypatch):
    _, _, model = models
    sig = rng.standard_normal((12, 640)).astype(np.float32)
    labels = np.zeros(71, np.float32)
    labels[[4, 10]] = 1.0
    monkeypatch.chdir(tmp_path)
    path = EcgVitVisualizer(model)(sig, labels, save=True)
    assert path and os.path.exists(path)


def test_viz_helpers_take_tensors(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    utils.plot_ecg(torch.randn(12, 300), title='t', save='ecg-tensor', show=False)
    assert os.path.exists(os.path.join('plots', 'ecg-tensor.png'))
    assert len(utils.vals2colors(torch.tensor([1.0, 2.0, 3.0]))) == 3


def test_cli_visualize_renders_the_served_weights(tmp_path, monkeypatch, capsys):
    """``cli visualize --checkpoint --ema-decay``: the figure is drawn from
    the checkpoint's EMA weights, on the normalized, always-padded and
    truncated record (the JAX CLI's preparation)."""
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))
    cfg = VitConfig.from_defined('debug')
    tr = ttrainer.Trainer(cfg, ttrainer.TrainConfig(ema_decay=0.9),
                          output_dir=str(tmp_path / 'run'), device='cpu')
    tr.init_state()
    with torch.no_grad():
        for v in tr.ema.values():
            v.mul_(0.5)
    ckpt = tr.save_checkpoint(tag='viz')
    seen = {}

    class Recording(EcgVitVisualizer):
        def __call__(self, sample_values, labels, save=False, layer=None):
            seen['state'] = {k: v.clone() for k, v in self.model.state_dict().items()}
            seen['sig'] = np.asarray(sample_values)
            return super().__call__(sample_values, labels, save=save, layer=layer)

    monkeypatch.setattr(utils, 'EcgVitVisualizer', Recording)
    monkeypatch.chdir(tmp_path)
    cli.main(['visualize', '--size', 'debug', '--synth-n', '64', '--checkpoint', ckpt,
              '--ema-decay', '0.9', '--stats', 'original', '--split', 'eval',
              '--index', '1'])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.exists(out['figure'])
    for key, val in tr.ema.items():
        assert torch.equal(seen['state'][key], val), key
    splits = get_ptbxl_splits(*synth_ptbxl(n=64))
    from ecg_representation_learning_tpu_torch.registry import PTBXL_TRAIN_STATS
    stats = PTBXL_TRAIN_STATS['original']
    raw = splits.eval.signals[1]
    want = (raw - np.asarray(stats['mean'], np.float32)[:, None]) \
        / np.asarray(stats['std'], np.float32)[:, None]
    want = np.pad(want, [(0, 0), (0, 64 - raw.shape[-1] % 64)])[:, :cfg.max_signal_length]
    np.testing.assert_allclose(seen['sig'], want, atol=1e-6, rtol=0)
    assert seen['sig'].shape == (12, 2560)
