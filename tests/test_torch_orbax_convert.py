"""``tools/orbax_to_port.py``: the JAX package's orbax checkpoints carried
into the port (``models.port.train_state_from_flax``).

  * A JAX ``Trainer`` at debug size (dropout 0, an EMA, the fused optimizer
    and the optax chain) trains 2 steps and saves ``ckpt-final``; the
    converter writes a port checkpoint, and a port ``Trainer`` restores it:
    ``predict_long`` and ``evaluate`` equal JAX's to 1e-4 (the logits bar of
    ``tests/test_weight_port.py``), and one further step on each side gives
    the same loss and gradient norm (rtol 1e-5, ``tests/test_torch_train.py``)
    and the same params, EMA and moments (rtol 2e-5, atol 1e-7,
    ``tests/test_torch_optim.py``'s bar for one FusedAdamW step);
  * converted MAE and contrastive checkpoints hand the same trunk to ``cli
    train --init-encoder`` (``load_any_encoder``) as JAX's handoff, bit for
    bit, and the CLI trains from it;
  * a JAX ``PipelineVitTrainer`` checkpoint (2 stages, 2 steps) becomes the
    one-device ``scan_blocks`` file: its params are JAX's ``merged_params()``
    and its moments JAX's merged moments, bit for bit, and a ``scan_blocks``
    ``Trainer`` restores it;
  * a JAX ``RingPretrainer`` checkpoint (2 devices, 1 step) restores into
    the port's ``RingPretrainer`` on 2 ranks with JAX's params, moments,
    count and step bit for bit, and one further step from JAX's mask gives
    JAX's loss (rtol 1e-5) and params (atol 1e-5), the bars of
    ``tests/test_torch_long_record.py``;
  * the script's ``--help`` says what it does not carry.
"""
import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import ContrastiveConfig as JaxContrastiveConfig
from ecg_representation_learning_tpu.configs import MaeConfig as JaxMaeConfig
from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models.vit import EcgVit as JaxEcgVit
from ecg_representation_learning_tpu.parallel import make_mesh as jax_mesh
from ecg_representation_learning_tpu.train import SplitData as JaxSplitData
from ecg_representation_learning_tpu.train import Trainer as JaxTrainer
from ecg_representation_learning_tpu.train import optim as joptim
from ecg_representation_learning_tpu.train.contrastive import ContrastiveTrainer as JaxCon
from ecg_representation_learning_tpu.train.contrastive import load_any_encoder as jax_handoff
from ecg_representation_learning_tpu.train.long_record import RingPretrainer as JaxRing
from ecg_representation_learning_tpu.train.long_record import _exact_count_mask as jax_ring_mask
from ecg_representation_learning_tpu.train.pipeline_vit import PipelineVitTrainer as JaxPipe
from ecg_representation_learning_tpu.train.pipeline_vit import make_pp_mesh as jax_pp_mesh
from ecg_representation_learning_tpu.train.pipeline_vit import merge_vit_params as jax_merge
from ecg_representation_learning_tpu.train.pretrain import MaeTrainer as JaxMae
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.port import (mim_state_dict_from_flax,
                                                               vit_state_dict_from_flax)
from ecg_representation_learning_tpu_torch.parallel import LocalRanks
from ecg_representation_learning_tpu_torch.train import Trainer
from ecg_representation_learning_tpu_torch.train import checkpoint
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer
from ecg_representation_learning_tpu_torch.train.contrastive import load_any_encoder
from ecg_representation_learning_tpu_torch.train.optim import adam_moments

import test_torch_ring_pipeline_ranks as ring_prog

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_TOL, RTOL = 1e-4, 1e-5
KW = dict(num_train_epoch=1, train_batch_size=8, eval_batch_size=8, learning_rate=1e-3,
          schedule='constant', warmup_ratio=0.0, ema_decay=0.9, log_to_console=False,
          do_eval=False)


def _tool():
    spec = importlib.util.spec_from_file_location('orbax_to_port',
                                                  os.path.join(ROOT, 'tools', 'orbax_to_port.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(21)
    sig = (0.5 * rng.standard_normal((16, 12, 256))).astype(np.float32)
    lab = (rng.uniform(size=(16, 71)) < 0.3).astype(np.float32)
    lab[0], lab[1] = 1.0, 0.0
    return sig, lab, (0.5 * rng.standard_normal((3, 12, 700))).astype(np.float32)


def _jcfg():
    return JaxVitConfig.from_defined('debug', max_signal_length=320, use_flash_attention=False,
                                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _flat(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize('fused', [True, False])
def test_converted_trainer_checkpoint_serves_and_trains_as_jax(fused, data, tmp_path):
    sig, lab, long_sig = data
    jcfg = _jcfg()
    tkw = dict(KW, fused_optimizer=fused)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(**tkw, prng_impl=jax.config.jax_default_prng_impl),
                     train_data=JaxSplitData(sig, lab), output_dir=str(tmp_path / 'jax'))
    jtr.train()                                  # 2 steps, then ckpt-final
    assert int(jtr.state.step) == 2
    path = _tool().convert(str(tmp_path / 'jax' / 'ckpt-final'), str(tmp_path / 'port'))
    assert path.endswith('ckpt-final') and os.path.exists(os.path.join(path, 'state.pt'))
    raw = checkpoint.restore_checkpoint(path)
    assert (raw['step'], raw['epoch'], raw['opt_state']['count']) == (2, 1, 2)
    assert 'rng' not in raw and 'ema_params' in raw

    cfg = VitConfig(**{**dataclasses.asdict(jcfg), 'use_flash_attention': True,
                       'flash_min_seq': 0})
    tr = Trainer(cfg, TrainConfig(**tkw), train_data=ttrainer.SplitData(sig, lab),
                 device='cpu', output_dir=str(tmp_path / 'port'))
    tr.load_checkpoint(path)
    assert tr.step == 2 and tr.epoch == 1 and tr.opt_state.count == 2
    np.testing.assert_allclose(tr.predict_long(long_sig), jtr.predict_long(long_sig),
                               rtol=0, atol=LOGITS_TOL)
    ev, jev = tr.evaluate(ttrainer.SplitData(sig, lab)), jtr.evaluate(JaxSplitData(sig, lab))
    np.testing.assert_allclose([ev['loss'], ev['macro_auc']], [jev['loss'], jev['macro_auc']],
                               rtol=LOGITS_TOL)

    take = np.arange(8, 16)
    m = tr.train_step(ttrainer.SplitData(sig, lab), take)
    sigs, labs, idx = jtr._step_inputs(jtr.train_data, take)
    with jtr.mesh:
        jtr.state, jm, _, _ = jtr._train_step(jtr.state, sigs, labs, idx,
                                             jax.numpy.zeros((), jax.numpy.int32))
    np.testing.assert_allclose([float(m['loss']), float(m['grad_norm'])],
                               [float(jm['loss']), float(jm['grad_norm'])], rtol=RTOL)
    jmu, jnu = joptim.adam_moments(jtr.state.opt_state)
    mu, nu = adam_moments(tr.opt_state)
    for got, want in ((tr.state_dict(), jtr.state.params), (tr.ema, jtr.state.ema_params),
                      (mu, jmu), (nu, jnu)):
        want = vit_state_dict_from_flax(_flat(want), cfg)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize('objective', ['mae', 'contrastive'])
def test_converted_pretrain_checkpoint_hands_over_the_jax_trunk(objective, tmp_path,
                                                                monkeypatch, capsys):
    jcfg = JaxVitConfig.from_defined('debug')   # the CLI's debug ViT takes the trunk
    tcfg = JaxTrainConfig(**{**KW, 'ema_decay': 0.0}, prng_impl=jax.config.jax_default_prng_impl)
    if objective == 'mae':
        jtr = JaxMae(jcfg, JaxMaeConfig(decoder_hidden_size=32, decoder_num_layers=1,
                                        decoder_num_heads=2, decoder_intermediate_size=64),
                     tcfg, output_dir=str(tmp_path / 'jax'))
    else:
        jtr = JaxCon(jcfg, JaxContrastiveConfig(proj_hidden_size=32, proj_dim=8), tcfg,
                     output_dir=str(tmp_path / 'jax'))
    jtr.init_state()
    jpath = jtr.save_checkpoint('final')
    path = _tool().convert(jpath, str(tmp_path / 'port'))
    vit = _flat(JaxEcgVit(jcfg).init({'params': jax.random.PRNGKey(3)},
                                     jax.numpy.zeros((1, 12, jcfg.max_signal_length))))
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    want = vit_state_dict_from_flax(_flat(jax_handoff(jpath, vit)), cfg)
    got = load_any_encoder(path, vit_state_dict_from_flax(vit, cfg))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    trunk = [k for k in want if k.startswith('encoder.')]
    assert not all(torch.equal(got[k], vit_state_dict_from_flax(vit, cfg)[k]) for k in trunk)
    # the CLI's handoff takes the converted directory as it is
    monkeypatch.setattr(ttrainer, 'default_device', lambda device=None: torch.device('cpu'))
    cli.main(['train', '--size', 'debug', '--epochs', '1', '--batch-size', '16',
              '--synth-n', '64', '--no-bf16', '--init-encoder', path,
              '--output-dir', str(tmp_path / 'ft')])
    assert np.isfinite(json.loads(capsys.readouterr().out.strip().splitlines()[-1])
                       ['best_eval_loss'])


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want), \
        [k for k in want if not torch.equal(got[k], want[k])]


def test_pipeline_checkpoint_becomes_the_scan_blocks_file(data, tmp_path):
    sig, lab, _ = data
    jcfg = dataclasses.replace(_jcfg(), scan_blocks=True)
    jtr = JaxPipe(jcfg, JaxTrainConfig(**{**KW, 'ema_decay': 0.0}, mesh_stage=2, mesh_data=1),
                  train_data=JaxSplitData(sig, lab), output_dir=str(tmp_path / 'jax'),
                  mesh=jax_pp_mesh(n_stage=2, n_data=1, devices=jax.devices()[:2]))
    jtr.train()                                  # 2 steps, then ckpt-final
    path = _tool().convert(str(tmp_path / 'jax' / 'ckpt-final'), str(tmp_path / 'port'))
    raw = checkpoint.restore_checkpoint(path)
    assert (raw['step'], raw['epoch'], raw['opt_state']['count']) == (2, 1, 2)
    assert 'ema_params' not in raw
    cfg = VitConfig(**dataclasses.asdict(jcfg))
    jmu, jnu = joptim.adam_moments(jtr.state.opt_state)
    for got, want in ((raw['params'], jtr.merged_params()),
                      (raw['opt_state']['mu'], jax_merge(jmu['outer'], jmu['stages'])),
                      (raw['opt_state']['nu'], jax_merge(jnu['outer'], jnu['stages']))):
        _same(got, vit_state_dict_from_flax(_flat(want), cfg))
    tr = Trainer(cfg, TrainConfig(log_to_console=False), device='cpu')
    tr.load_checkpoint(path)
    assert (tr.step, tr.epoch) == (2, 1)
    _same(tr.state_dict(), raw['params'])


def test_converted_ring_checkpoint_resumes_as_jax(tmp_path):
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=512, patch_size=64,
                                     num_channels=4, use_flash_attention=False, ring_axis='data',
                                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tkw = dict(learning_rate=1e-4, schedule='constant', warmup_ratio=0.0)
    jtr = JaxRing(jcfg, JaxTrainConfig(**tkw), jax_mesh(2, 1, devices=jax.devices()[:2]),
                  total_steps=2, output_dir=str(tmp_path / 'jax'))
    jtr.init(seed=0)
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((2, 4, 512)).astype(np.float32) for _ in range(2)]
    with jax.default_matmul_precision('highest'):
        jtr.train(iter(xs), steps=1)
    jpath = jtr.save_checkpoint()                # ckpt-step1
    saved = _flat(jtr.state.params)
    jmu, jnu = (_flat(m) for m in joptim.adam_moments(jtr.state.opt_state))
    _, mask_key = jax.random.split(jtr.state.rng)          # the mask of JAX's next step
    mask = np.asarray(jax_ring_mask(mask_key, 2, jcfg.num_patches,
                                    int(round(jcfg.num_patches * jtr.mask_ratio))))
    with jax.default_matmul_precision('highest'), jtr.mesh:
        jtr.state, jloss = jtr._step(jtr.state, jax.numpy.asarray(xs[1]))
    path = _tool().convert(jpath, str(tmp_path / 'port'))
    assert path.endswith('ckpt-step1')

    cfg = VitConfig(**dataclasses.asdict(jcfg))
    with LocalRanks(2) as ranks:
        out = ranks.run(ring_prog.ring_resume, cfg, TrainConfig(**tkw), path, xs[1],
                        torch.tensor(mask), 2)
    (params, count, mu, nu, step), loss, after = out[0]
    assert (count, step) == (1, 1)
    for got, want in ((params, saved), (mu, jmu), (nu, jnu)):
        _same(got, mim_state_dict_from_flax(want, cfg))
    # one further step: tests/test_torch_long_record.py's bars for a ring step
    assert all(o[1] == loss for o in out)
    np.testing.assert_allclose(loss, float(jloss), rtol=RTOL)
    want = mim_state_dict_from_flax(_flat(jtr.state.params), cfg)
    for k in want:
        np.testing.assert_allclose(after[k].numpy(), want[k].numpy(), rtol=0, atol=RTOL,
                                   err_msg=k)


def test_help_says_the_generators_are_not_carried(capsys):
    with pytest.raises(SystemExit):
        _tool().main(['--help'])
    text = ' '.join(capsys.readouterr().out.split())
    assert 'Does NOT carry the random-generator state' in text
