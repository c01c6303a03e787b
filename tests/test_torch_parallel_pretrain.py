"""The port's pretrainers on 2 x 2 gloo CPU ranks against the JAX mesh, and
the mesh's entry points.

One group of four ranks for the file (``parallel.LocalRanks``; the rank
programs are in ``tests/test_torch_parallel_ranks.py``).  The JAX trainers
run on a 2 x 2 mesh of the 8 CPU devices of ``tests/conftest.py``, two
steps, dropout off; the port starts from JAX's weights and is fed JAX's
randomness for the global batch (the MAE mask noise of each microbatch,
replayed from the step's mask key, and the two views' draws), each rank
keeping its rows:

  * ``MaeTrainer`` with ``grad_accum=2`` and ``ema_decay=0.9``, ``fsdp``
    off and on;
  * ``ContrastiveTrainer``: NT-Xent over the global batch (the projections
    all-gathered over 'data'), ``fsdp`` off and on;

each step's loss to 1e-5 relative and every parameter to 1e-5 max abs (the
learning rate is 1e-4: an Adam step can move a weight whose gradient is at
rounding level by 2 lr).  Then ``tools/dryrun_multichip.py`` at 2 x 2 (all
six legs) and ``cli --platform cpu --host-devices 4 train --mesh-model 2
--fsdp``, end to end.
"""
import dataclasses
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecg_representation_learning_tpu.configs import ContrastiveConfig as JaxContrastiveConfig
from ecg_representation_learning_tpu.configs import MaeConfig as JaxMaeConfig
from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.parallel import make_mesh as jax_mesh
from ecg_representation_learning_tpu.train import contrastive as jtcon
from ecg_representation_learning_tpu.train import pretrain as jpre
from ecg_representation_learning_tpu.train.trainer import SplitData as JaxSplitData
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.port import state_dict_from_flax
from ecg_representation_learning_tpu_torch.parallel import LocalRanks
from ecg_representation_learning_tpu_torch.tools import dryrun_multichip
from ecg_representation_learning_tpu_torch.train import SplitData

import test_torch_parallel_ranks as prog
from test_torch_contrastive import jax_view_draws

RTOL = ATOL = 1e-5
BS = 16
KW = dict(num_train_epoch=1, train_batch_size=BS, eval_batch_size=BS, learning_rate=5e-6,
          log_to_console=False, save_final=False)
JCFG = JaxVitConfig.from_defined('debug', max_signal_length=256, use_flash_attention=False,
                                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
JMAE = JaxMaeConfig(**dataclasses.asdict(prog.MAE))
JCON = JaxContrastiveConfig(**dataclasses.asdict(prog.CON))


@pytest.fixture(scope='module')
def ranks():
    with LocalRanks(4) as r:
        yield r


@pytest.fixture(scope='module')
def data():
    sig = (0.5 * np.random.default_rng(8).standard_normal((2 * BS, 12, 256))).astype(np.float32)
    return sig, np.zeros((2 * BS, 1), np.float32)


def _flax_rng(key, stream: str):
    """The key ``self.make_rng(stream)`` gives a top-level flax module whose
    ``apply`` got ``rngs={stream: key}`` (the JAX MAE draws its mask so)."""
    class Draw(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng(stream)
    return Draw().apply({}, rngs={stream: key})


def _jax_steps(jtr, data, n_steps, replay):
    """``n_steps`` JAX steps on its mesh: (init params, per step (metrics, the
    draws for the port, params after))."""
    jtr.init_state()
    jtr._build_step()
    init = jax.tree.map(np.asarray, jtr.state.params)
    nonfinite, out = jnp.zeros((), jnp.int32), []
    for k in range(n_steps):
        draws = replay(jax.random.split(jtr.state.rng, 3)[1])
        sigs, idx = jtr._sig_inputs(data, np.arange(BS * k, BS * (k + 1)))
        with jtr.mesh:
            jtr.state, metrics, nonfinite = jtr._train_step(jtr.state, sigs, idx, nonfinite)
        out.append(({k: float(v) for k, v in metrics.items()}, draws,
                    jax.tree.map(np.asarray, jtr.state.params)))
    return init, out


def _check(kind, cfg, got, steps):
    template = prog.model_of(kind, cfg)
    for (loss, grad_norm, state), (want, _, after) in zip(got, steps):
        np.testing.assert_allclose(loss, want['loss'], rtol=RTOL)
        np.testing.assert_allclose(grad_norm, want['grad_norm'], rtol=1e-4)
        want_state = state_dict_from_flax(after, template)
        for name, val in want_state.items():
            np.testing.assert_allclose(state[name].numpy(), val.numpy(), rtol=0, atol=ATOL,
                                       err_msg=name)


def _mesh():
    return jax_mesh(2, 2, devices=jax.devices()[:4])


@pytest.fixture(scope='module')
def jax_mae(data):
    tcfg = JaxTrainConfig(**KW, mesh_model=2, grad_accum=2, ema_decay=0.9,
                          prng_impl=jax.config.jax_default_prng_impl)
    jtr = jpre.MaeTrainer(JCFG, JMAE, tcfg, mesh=_mesh())
    n_patch = JCFG.max_signal_length // JCFG.patch_size

    def replay(key):   # one noise per microbatch, from the microbatch's mask key
        return [np.array(jax.random.uniform(_flax_rng(k, 'mask'), (BS // 2, n_patch)))
                for k in jax.random.split(key, 2)]
    return _jax_steps(jtr, JaxSplitData(*data), 2, replay)


@pytest.fixture(scope='module')
def jax_con(data):
    tcfg = JaxTrainConfig(**KW, mesh_model=2, prng_impl=jax.config.jax_default_prng_impl)
    jtr = jtcon.ContrastiveTrainer(JCFG, JCON, tcfg, mesh=_mesh())

    def replay(key):
        return [jax_view_draws(k, (BS, 12, 256), prog.CON) for k in jax.random.split(key)]
    return _jax_steps(jtr, JaxSplitData(*data), 2, replay)


def _torchify(steps, kind):
    import torch
    if kind == 'mae':
        return [[torch.from_numpy(n) for n in draws] for _, draws, _ in steps]
    return [draws for _, draws, _ in steps]


@pytest.mark.parametrize('fsdp', [False, True])
def test_mae_accum_ema_steps_on_2x2_match_the_jax_mesh(ranks, jax_mae, data, fsdp):
    init, steps = jax_mae
    cfg = VitConfig(**dataclasses.asdict(JCFG))
    tcfg = TrainConfig(**KW, mesh_model=2, fsdp=fsdp, grad_accum=2, ema_decay=0.9)
    out = ranks.run(prog.replay_steps, 'mae', cfg, tcfg, (2, 2), SplitData(*data), init,
                    _torchify(steps, 'mae'))
    _check('mae', cfg, out[0], steps)
    assert [o[0] for o in out[1]] == [o[0] for o in out[0]]   # one loss on every rank


@pytest.mark.parametrize('fsdp', [False, True])
def test_contrastive_steps_on_2x2_match_the_jax_mesh(ranks, jax_con, data, fsdp):
    init, steps = jax_con
    cfg = VitConfig(**dataclasses.asdict(JCFG))
    tcfg = TrainConfig(**KW, mesh_model=2, fsdp=fsdp)
    out = ranks.run(prog.replay_steps, 'con', cfg, tcfg, (2, 2), SplitData(*data), init,
                    _torchify(steps, 'con'))
    _check('con', cfg, out[0], steps)


def test_dryrun_multichip_at_2x2(capsys):
    assert dryrun_multichip.main(['--ranks', '4']) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary['mesh'] == {'data': 2, 'model': 2}
    sup = summary['supervised']
    assert abs(sup['eval_loss'] - sup['restored_eval_loss']) < 1e-5
    assert np.prod(summary['mae']['mu_shape']) < np.prod(summary['mae']['megatron_shape'])
    assert summary['moe']['experts_per_rank'] == 2
    assert np.isfinite(summary['contrastive']['loss'])
    # legs 5 and 6: ring context parallelism over 4 shards, GPipe over 4 stages
    assert summary['ring']['shards'] == 4 and all(np.isfinite(summary['ring']['losses']))
    assert summary['pipeline']['mesh'] == {'data': 1, 'stage': 4}
    assert summary['pipeline']['layers_per_stage'] == 1
    assert np.isfinite(summary['pipeline']['loss'])


def test_cli_train_on_four_cpu_ranks_with_tp_and_fsdp(tmp_path, capfd):
    cli.main(['--platform', 'cpu', '--host-devices', '4', 'train', '--size', 'debug',
              '--no-bf16', '--epochs', '1', '--batch-size', '16', '--synth-n', '96',
              '--mesh-model', '2', '--fsdp', '--output-dir', str(tmp_path)])
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith('{')]
    assert len(lines) == 1                      # rank 0 prints the result
    result = json.loads(lines[0])
    assert np.isfinite(result['best_eval_loss']) and result['epochs'] == 1
    assert (tmp_path / 'ckpt-final' / 'state.pt').is_file()
