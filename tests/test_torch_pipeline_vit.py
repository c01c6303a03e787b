"""The port's pipeline-parallel ViT (``train/pipeline_vit.py``) against the
JAX package's, and ``cli train --mesh-stage`` end to end.

One group of four gloo CPU ranks for the file (the rank programs are in
``tests/test_torch_ring_pipeline_ranks.py``); the JAX side runs on a 2 x 2
('data', 'stage') mesh of four of the 8 CPU devices at
``precision='highest'``.  'debug' ViT with ``scan_blocks`` (4 layers, 2 a
stage), 320 samples, dropout off, n_micro 4, from JAX's init:

  * ``split_vit_params``/``merge_vit_params`` round trip exactly, and a JAX
    (outer, stages) pair carried over by ``models.port`` equals the JAX
    model's own tree carried over;
  * ``pipeline_vit_forward``: the logits within 1e-5 relative of JAX's,
    the BCE loss likewise, each gradient leaf within 1e-4 relative
    (||a - b|| / ||b||) -- the boundary summed over 'stage', every leaf
    averaged over 'data';
  * ``PipelineVitTrainer.train()``, two steps with TimeOut off and a clip
    of 1e-5 (it bites, and Adam's eps then makes the update depend on the
    clipped norm, so the staged norm is tested): each loss within 1e-5
    relative, the merged parameters within 1e-5 relative over the tree and
    1e-5 max abs; each rank holds its stage's layers and their moments only;
  * the refusals: a split smaller than a batch, ``grad_accum``,
    ``ema_decay``, one stage;
  * ``cli --platform cpu --host-devices 4 train --mesh-stage 2`` prints the
    mesh "2 data x 2 stage", writes whole stacks, and ``--resume-from`` its
    checkpoint continues the step count from the restored weights;
  (``tools/dryrun_multichip.py --ranks 4``, legs 5 and 6 included, is
  ``tests/test_torch_parallel_pretrain.py::test_dryrun_multichip_at_2x2``.)
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models.vit import EcgVit as JaxEcgVit
from ecg_representation_learning_tpu.models.vit import bce_with_logits as jax_bce
from ecg_representation_learning_tpu.train import SplitData as JaxSplitData
from ecg_representation_learning_tpu.train.pipeline_vit import (
    PipelineVitTrainer as JaxPipelineTrainer, make_pp_mesh as jax_pp_mesh,
    merge_vit_params as jax_merge, pipeline_vit_forward as jax_forward,
    split_vit_params as jax_split)
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.port import (pipeline_state_dict_from_flax,
                                                               vit_state_dict_from_flax)
from ecg_representation_learning_tpu_torch.parallel import LocalRanks
from ecg_representation_learning_tpu_torch.train import PipelineVitTrainer, SplitData
from ecg_representation_learning_tpu_torch.train.pipeline_vit import (merge_vit_params,
                                                                      split_vit_params)

import test_torch_ring_pipeline_ranks as prog

JCFG = JaxVitConfig.from_defined('debug', max_signal_length=320, use_flash_attention=False,
                                 scan_blocks=True, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
KW = dict(num_train_epoch=1, train_batch_size=16, mesh_data=2, mesh_stage=2, learning_rate=1e-4,
          grad_clip_norm=1e-5, do_eval=False, save_final=False, log_to_console=False)


@pytest.fixture(scope='module')
def ranks():
    with LocalRanks(4) as r:
        yield r


def _port_cfg():
    # the port's flash wrapper (its plain version here) where JAX runs XLA's
    return dataclasses.replace(VitConfig(**dataclasses.asdict(JCFG)), use_flash_attention=True,
                               flash_min_seq=0)


def _rel(a, b) -> float:
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope='module')
def setup():
    rng = np.random.default_rng(3)
    sig = rng.standard_normal((16, 12, 320)).astype(np.float32)
    lab = (rng.uniform(size=(16, 71)) > 0.9).astype(np.float32)
    variables = JaxEcgVit(JCFG).init({'params': jax.random.PRNGKey(0)}, jnp.asarray(sig[:1]))
    return jax.tree.map(np.asarray, variables), sig, lab


def test_split_merge_round_trip_and_the_jax_pair(setup):
    variables, _, _ = setup
    cfg = _port_cfg()
    full = vit_state_dict_from_flax(variables, cfg)
    outer, stages = split_vit_params(full, 2)
    assert stages['attn.qkv.weight'].shape[:2] == (2, 2)
    merged = merge_vit_params(outer, stages)
    assert merged.keys() == full.keys()
    assert all(torch.equal(merged[k], full[k]) for k in full)
    j_outer, j_stages = jax_split(variables, 2)
    carried = pipeline_state_dict_from_flax(j_outer, j_stages, cfg)
    assert all(torch.equal(carried[k], full[k]) for k in full)
    back = jax_merge(j_outer, j_stages)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_forward_and_gradients_on_2x2_match_jax(ranks, setup):
    variables, sig, lab = setup
    mesh = jax_pp_mesh(n_stage=2, n_data=2, devices=jax.devices()[:4])
    outer, stages = jax_split(variables, 2)

    def loss_fn(params):
        logits = jax_forward(JCFG, params['outer'], params['stages'], jnp.asarray(sig), mesh,
                             n_micro=4)
        return jax_bce(logits, jnp.asarray(lab)), logits
    with jax.default_matmul_precision('highest'):
        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            {'outer': outer, 'stages': stages})
    cfg = _port_cfg()
    out = ranks.run(prog.pp_forward_grad, cfg, vit_state_dict_from_flax(variables, cfg),
                    torch.from_numpy(sig), torch.from_numpy(lab), 2, 4)
    logits = np.asarray(logits)
    for got, rows, got_loss, _ in out:
        assert _rel(got.numpy(), logits[rows]) <= 1e-5
        assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
    want = pipeline_state_dict_from_flax(jax.tree.map(np.asarray, grads['outer']),
                                         jax.tree.map(np.asarray, grads['stages']), cfg)
    got = out[0][3]
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-4, (k, _rel(got[k], want[k]))
        assert all(torch.equal(o[3][k], got[k]) for o in out)   # every rank the same


@pytest.fixture(scope='module')
def jax_trainer(setup):
    """JAX ``PipelineVitTrainer.train()`` on 2 x 2, two steps: (init merged
    params, per-step losses, final merged params, the data)."""
    variables, _, _ = setup
    rng = np.random.default_rng(4)
    sig = (0.5 * rng.standard_normal((32, 12, 320))).astype(np.float32)
    lab = (rng.uniform(size=(32, 71)) < 0.2).astype(np.float32)
    tr = JaxPipelineTrainer(JCFG, JaxTrainConfig(**KW), train_data=JaxSplitData(sig, lab),
                            mesh=jax_pp_mesh(n_stage=2, n_data=2, devices=jax.devices()[:4]))
    tr.init_state()
    tr.set_merged_params(variables)
    tr._build_step()
    losses, step = [], tr._train_step
    tr._train_step = lambda s, x, y: (lambda r: (losses.append(float(r[1])), r)[1])(step(s, x, y))
    with jax.default_matmul_precision('highest'):
        tr.train()
    return losses, jax.tree.map(np.asarray, tr.merged_params()), (sig, lab)


def test_trainer_steps_with_the_clip_on_2x2_match_jax(ranks, setup, jax_trainer, tmp_path):
    variables, _, _ = setup
    losses, final, data = jax_trainer
    cfg = _port_cfg()
    out = ranks.run(prog.pp_train, cfg, TrainConfig(**KW), SplitData(*data),
                    vit_state_dict_from_flax(variables, cfg), str(tmp_path))
    assert len(losses) == 2
    for r in out:
        np.testing.assert_allclose(r['losses'], losses, rtol=1e-5)
    want = vit_state_dict_from_flax(final, cfg)
    got = out[0]['merged']
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    assert (num / den) ** 0.5 <= 1e-5
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    qkv = 'encoder.blocks.attn.qkv.weight'
    for r in out:   # each rank: its stage's 2 of the 4 layers, and their moments
        assert r['local'][qkv] == r['mu'][qkv] == (2, 3 * 64, 64)
        assert r['local']['encoder.pos_embed'] == want['encoder.pos_embed'].shape
    assert [r['stage'] for r in out] == [0, 1, 0, 1]          # rank = d * S + s


def test_refusals(ranks, tmp_path):
    cfg = _port_cfg()
    for bad in (dict(grad_accum=2), dict(ema_decay=0.9)):
        with pytest.raises(NotImplementedError, match='grad_accum/ema_decay'):
            PipelineVitTrainer(cfg, TrainConfig(**{**KW, **bad}))
    with pytest.raises(ValueError, match='mesh_stage == 1'):
        PipelineVitTrainer(cfg, TrainConfig(**{**KW, 'mesh_stage': 1}))
    with pytest.raises(ValueError, match='scan_blocks'):
        PipelineVitTrainer(dataclasses.replace(cfg, scan_blocks=False), TrainConfig(**KW))
    small = SplitData(np.zeros((8, 12, 320), np.float32), np.zeros((8, 71), np.float32))
    with pytest.raises(RuntimeError, match='smaller than one batch'):
        ranks.run(prog.pp_train, cfg, TrainConfig(**KW), small, None, str(tmp_path))


def _cli(tmp_path, capfd, *extra):
    cli.main(['--platform', 'cpu', '--host-devices', '4', 'train', '--size', 'debug',
              '--synth-n', '96', '--epochs', '1', '--batch-size', '16', '--mesh-stage', '2',
              '--output-dir', str(tmp_path), *extra])
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith('{')]
    assert len(lines) == 1                      # rank 0 prints the result
    return json.loads(lines[0])


def test_cli_train_mesh_stage_and_its_resume(tmp_path, capfd):
    first = _cli(tmp_path, capfd)
    assert first['mesh'] == '2 data x 2 stage' and np.isfinite(first['train_loss'])
    assert first['test_macro_auc'] is None or 0.0 <= first['test_macro_auc'] <= 1.0
    ckpt = tmp_path / 'ckpt-final'
    raw = torch.load(ckpt / 'state.pt', weights_only=True)
    assert raw['params']['encoder.blocks.attn.qkv.weight'].shape[0] == 4   # whole stacks
    second = _cli(tmp_path, capfd, '--resume-from', str(ckpt))
    assert np.isfinite(second['train_loss'])
    # the resumed run continued the restored state: its steps counted on from
    # the first run's, and from its weights (the cosine schedule has reached 0
    # by then, so they are kept exactly; dropout makes the losses noisy)
    raw2 = torch.load(ckpt / 'state.pt', weights_only=True)
    assert raw['step'] > 0 and raw2['step'] == 2 * raw['step']
    assert all(torch.equal(raw2['params'][k], v) for k, v in raw['params'].items())

