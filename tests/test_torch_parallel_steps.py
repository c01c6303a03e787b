"""The port's mesh trainers on 2 x 2 gloo CPU ranks against the JAX mesh.

One group of four ranks for the file (``parallel.LocalRanks``; the rank
programs are in ``tests/test_torch_parallel_ranks.py``).  The JAX side runs
its ``Trainer`` on a 2 x 2 mesh of the 8 CPU devices of
``tests/conftest.py``; both sides start from JAX's init
(``models.port.state_dict_from_flax``), with dropout off:

  * two steps of ``Trainer.train()`` with ``fsdp`` off and on: every logged
    loss and the eval loss to 1e-5 relative, every parameter to 1e-5 max
    abs;
  * the Switch-MoE ViT (4 experts on every second block) with expert
    parallelism: two steps and the eval against JAX's, each rank holding
    E / n_model = 2 experts;
  * the mesh-wide FusedAdamW norm of sharded and replicated leaves: JAX's
    global norm with the clip, and a non-finite gradient on one rank zeroes
    the step on every rank;
  * a checkpoint saved under FSDP restores onto one device and onto the mesh
    without FSDP, with the eval loss within 1e-5;
  * the scan-stacked ViT on 2 x 2, with and without FSDP, equals the port's
    one-device steps (to 1e-6).

The learning rate is 1e-4: an Adam step can move a weight whose gradient is
at rounding level by 2 lr, which stays inside the 1e-5 bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.parallel import make_mesh as jax_mesh
from ecg_representation_learning_tpu.train import SplitData as JaxSplitData
from ecg_representation_learning_tpu.train import Trainer as JaxTrainer
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.ops import adamw
from ecg_representation_learning_tpu_torch.parallel import LocalRanks
from ecg_representation_learning_tpu_torch.train import SplitData

import test_torch_parallel_ranks as prog

RTOL = ATOL = 1e-5
KW = dict(num_train_epoch=1, train_batch_size=16, eval_batch_size=16, learning_rate=1e-4,
          log_to_console=False, save_final=False)


@pytest.fixture(scope='module')
def ranks():
    with LocalRanks(4) as r:
        yield r


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(5)
    sig = (0.5 * rng.standard_normal((32, 12, 256))).astype(np.float32)
    lab = (rng.uniform(size=(32, 71)) < 0.2).astype(np.float32)
    return sig, lab


def _jax_run(cfg: JaxVitConfig, data, tmp_path, **kw):
    """JAX ``Trainer.train()`` on a 2 x 2 mesh: (logged losses, eval history,
    init params, final params)."""
    sig, lab = data
    split = JaxSplitData(sig, lab)
    jtr = JaxTrainer(cfg, JaxTrainConfig(**KW, **kw, mesh_model=2,
                                         prng_impl=jax.config.jax_default_prng_impl),
                     train_data=split, eval_data=split,
                     mesh=jax_mesh(2, 2, devices=jax.devices()[:4]), output_dir=str(tmp_path))
    logged, log = [], jtr._log
    jtr._log = lambda p: (logged.append(p), log(p))
    jtr.init_state()
    init = jax.tree.map(np.asarray, jtr.state.params)
    res = jtr.train()
    return ([p['train/loss'] for p in logged if 'train/loss' in p],
            [h['loss'] for h in res['history']], init,
            jax.tree.map(np.asarray, jtr.state.params))


def _close_states(got, want_flax, model_cfg):
    from ecg_representation_learning_tpu_torch.models.port import vit_state_dict_from_flax
    want = vit_state_dict_from_flax(want_flax, model_cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=ATOL, err_msg=k)


def _port_cfg(jcfg):
    return VitConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope='module')
def vit_cfg():
    return JaxVitConfig.from_defined('debug', max_signal_length=320, use_flash_attention=False,
                                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(scope='module')
def jax_vit(vit_cfg, data, tmp_path_factory):
    return _jax_run(vit_cfg, data, tmp_path_factory.mktemp('jax'))


@pytest.mark.parametrize('fsdp', [False, True])
def test_trainer_steps_on_2x2_match_the_jax_mesh(ranks, vit_cfg, jax_vit, data, fsdp,
                                                  tmp_path):
    losses, history, init, final = jax_vit
    # the port's flash attention (its plain version here) where JAX runs XLA's
    cfg = dataclasses.replace(_port_cfg(vit_cfg), use_flash_attention=True, flash_min_seq=0)
    out = ranks.run(prog.train_run, 'sup', cfg, TrainConfig(**KW, mesh_model=2, fsdp=fsdp),
                    (2, 2), SplitData(*data), init, str(tmp_path))
    got = out[0]
    assert len(losses) == len(got['losses']) == 2
    np.testing.assert_allclose(got['losses'], losses, rtol=RTOL)
    np.testing.assert_allclose(got['history'], history, rtol=RTOL)
    _close_states(got['state'], final, cfg)
    assert all(r['losses'] == got['losses'] for r in out)   # one loss on every rank
    qkv = 'encoder.blocks.0.attn.qkv.weight'
    h = cfg.hidden_size
    shape = (3 * h // 2, h // 2) if fsdp else (3 * h // 2, h)   # Megatron rows, FSDP cols
    assert out[0]['local_shapes'][qkv] == out[0]['mu_shapes'][qkv] == shape


def test_moe_expert_parallel_on_2x2_matches_the_jax_mesh(ranks, vit_cfg, data, tmp_path):
    jcfg = dataclasses.replace(vit_cfg, moe_num_experts=4, moe_every=2)
    losses, history, init, final = _jax_run(jcfg, data, tmp_path / 'jax')
    cfg = _port_cfg(jcfg)
    out = ranks.run(prog.train_run, 'sup', cfg, TrainConfig(**KW, mesh_model=2), (2, 2),
                    SplitData(*data), init, str(tmp_path / 'port'))
    np.testing.assert_allclose(out[0]['losses'], losses, rtol=RTOL)
    np.testing.assert_allclose(out[0]['history'], history, rtol=RTOL)
    _close_states(out[0]['state'], final, cfg)
    for r in out:   # each rank holds E / n_model experts
        assert r['local_shapes']['encoder.blocks.1.moe.w1'][0] == 2
        assert r['local_shapes']['encoder.blocks.1.moe.router.weight'][0] == 4


@pytest.mark.parametrize('clip', [None, 1.0, 1e3])
def test_mesh_norm_matches_jax_global_norm_with_clip(ranks, clip):
    rng = np.random.default_rng(3)
    shapes = [(8, 6), (12,), (4, 3, 8), (5,)]
    shards = [0, 0, 2, None]           # three sharded leaves, one replicated
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    want = float(optax.global_norm([jnp.asarray(g.numpy()) for g in grads]))
    out = ranks.run(prog.mesh_norm, grads, shards, clip)
    one = [torch.ones_like(g) for g in grads]
    ref_norm, _ = adamw.adamw_tail_reference(
        one, grads, [torch.zeros_like(g) for g in grads], [torch.zeros_like(g) for g in grads],
        (1e-2, 0.1, 0.001), clip_norm=clip, zero_nonfinite=True, b1=0.9, b2=0.999, eps=1e-8,
        wd=0.0)
    for r, (norm, count, params) in enumerate(out):
        np.testing.assert_allclose(norm, want, rtol=1e-6)
        assert count == 0
        for p, full, dim in zip(params, one, shards):
            mine = full if dim is None else full.chunk(4, dim)[r]
            torch.testing.assert_close(p, mine, rtol=1e-6, atol=1e-7)
    assert abs(float(ref_norm) - want) <= 1e-6 * want


def test_a_nonfinite_gradient_on_one_rank_zeroes_the_step_everywhere(ranks):
    rng = np.random.default_rng(4)
    grads = [torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((6,)).astype(np.float32))]
    out = ranks.run(prog.mesh_norm, grads, [0, None], 1.0, 2)
    for norm, count, params in out:
        assert not np.isfinite(norm) and count == 1
        assert all(torch.equal(p, torch.ones_like(p)) for p in params)   # unpoisoned


def test_fsdp_checkpoint_restores_onto_one_device_and_onto_the_mesh(ranks, vit_cfg, data,
                                                                      tmp_path):
    cfg = _port_cfg(vit_cfg)
    tcfg = TrainConfig(**{**KW, 'save_final': True}, mesh_model=2, fsdp=True, ema_decay=0.9)
    split = SplitData(*data)
    out = ranks.run(prog.save_and_eval, 'sup', cfg, tcfg, (2, 2), split, str(tmp_path))
    ev, path = out[0]
    assert path and all(o == out[0] for o in out)
    one = prog.restore_and_eval('sup', cfg, dataclasses.replace(tcfg, mesh_model=1, fsdp=False),
                                None, split, path)
    mesh = ranks.run(prog.restore_and_eval, 'sup', cfg, dataclasses.replace(tcfg, fsdp=False),
                     (2, 2), split, path)
    assert abs(one - ev) <= 1e-5 and all(abs(m - ev) <= 1e-5 for m in mesh)


@pytest.mark.parametrize('fsdp', [False, True])
def test_scan_stacked_blocks_on_2x2_equal_the_one_device_steps(ranks, vit_cfg, data, fsdp):
    """``scan_blocks``: the (L, ...) stacks sharded on their original dims
    (the JAX rule's shifted spec), each layer run through the template with
    its Megatron role; FSDP2's root holds the stacks."""
    cfg = dataclasses.replace(_port_cfg(vit_cfg), scan_blocks=True)
    tcfg = TrainConfig(**KW)
    want_losses, want, _ = prog.dp_steps(cfg, tcfg, SplitData(*data), None)
    out = ranks.run(prog.dp_steps, cfg, dataclasses.replace(tcfg, mesh_model=2, fsdp=fsdp),
                    SplitData(*data), (2, 2))
    np.testing.assert_allclose(out[0][0], want_losses, rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(out[0][1][k].numpy(), want[k].numpy(), rtol=0, atol=1e-6)
