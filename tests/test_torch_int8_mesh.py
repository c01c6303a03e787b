"""int8 inference of the port's ``Trainer`` on a mesh against the JAX
package's.

JAX quantizes the served tree and replicates it on any ('data', 'model')
mesh (``Trainer.enable_int8_inference``); the port gathers the full served
state on every rank, quantizes it with the same ``quantize_int8`` and serves
one unsharded int8 model per rank, each data rank computing its rows of a
batch.  The port's ranks are gloo CPU ranks (``parallel.LocalRanks``; the
rank program is ``tests/test_torch_parallel_ranks.py::int8_serving``), the
JAX side runs on as many of the 8 CPU devices of ``tests/conftest.py``.
Both start from JAX's init, dropout off:

  * DP 2, FSDP 2, a 2 x 2 (data, model) mesh and a Switch-MoE with expert
    parallelism 2 (on 2 x 2): int8 ``predict_long`` and ``evaluate`` (loss,
    macro-AUROC) equal JAX's int8 ``Trainer`` on the same mesh to 1e-5, the
    bar of ``tests/test_torch_quantize.py``, and the port's one-device int8
    on the same weights to 1e-5; every rank gets the same answers;
  * ``disable_int8_inference`` returns the sharded results bit for bit;
  * the snapshot's float leaves are the full tensors, and the replicated
    model holds no f32 copy of a quantized leaf;
  * with an EMA, after two FSDP steps: int8 serves the gathered EMA, as the
    one-device int8 of that state;
  * ``cli --platform cpu --host-devices 2 infer --int8`` writes the codes
    of the one-device run;
  * ``serve`` on a mesh: rank 0 answers concurrent clients, the other rank
    follows every dispatch, and each client's rows are the one-device int8
    ``predict`` of its input; a batch that raises on every rank is answered
    with the error and the ranks go on serving the next request.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.parallel import make_mesh as jax_mesh
from ecg_representation_learning_tpu.train import SplitData as JaxSplitData
from ecg_representation_learning_tpu.train import Trainer as JaxTrainer
from ecg_representation_learning_tpu_torch import cli
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.vit import EcgVit
from ecg_representation_learning_tpu_torch.parallel import LocalRanks
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer

import test_torch_parallel_ranks as prog

torch.set_num_threads(2)
TOL = 1e-5
KW = dict(eval_batch_size=8, train_batch_size=8, num_train_epoch=1, learning_rate=1e-3,
          log_to_console=False, save_final=False)
# layout: (n_data, n_model, fsdp, MoE experts)
LAYOUTS = {'dp2': (2, 1, False, 0), 'fsdp2': (2, 1, True, 0), '2x2': (2, 2, False, 0),
           'moe_ep2': (2, 2, False, 4)}


@pytest.fixture(scope='module')
def ranks2():
    with LocalRanks(2) as r:
        yield r


@pytest.fixture(scope='module')
def ranks4():
    with LocalRanks(4) as r:
        yield r


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(11)
    sig = (0.5 * rng.standard_normal((16, 12, 256))).astype(np.float32)
    lab = (rng.uniform(size=(16, 71)) < 0.3).astype(np.float32)
    lab[0] = 1.0
    lab[1] = 0.0                  # every class has both outcomes
    signals = (0.5 * rng.standard_normal((5, 12, 700))).astype(np.float32)  # windows
    return sig, lab, signals


def _jax_cfg(experts):
    cfg = JaxVitConfig.from_defined('debug', max_signal_length=320, use_flash_attention=False,
                                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return dataclasses.replace(cfg, moe_num_experts=experts, moe_every=2) if experts else cfg


def _port_cfg(jcfg):
    return VitConfig(**{**dataclasses.asdict(jcfg), 'use_flash_attention': True,
                        'flash_min_seq': 0})


def _jax_int8(jcfg, n_data, n_model, fsdp, data):
    """JAX's int8 ``Trainer`` on an (n_data, n_model) mesh of CPU devices:
    (init params, (predict_long, eval loss, eval macro-AUROC))."""
    sig, lab, signals = data
    mesh = jax_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])
    jtr = JaxTrainer(jcfg, JaxTrainConfig(**KW, mesh_model=n_model, fsdp=fsdp,
                                          prng_impl=jax.config.jax_default_prng_impl),
                     mesh=mesh)
    jtr.init_state()
    params = jax.tree.map(np.asarray, jtr.state.params)
    jtr.enable_int8_inference()
    ev = jtr.evaluate(JaxSplitData(sig, lab))
    return params, (jtr.predict_long(signals), ev['loss'], ev['macro_auc'])


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=TOL, atol=0)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_int8_on_a_mesh_matches_jax_and_one_device(layout, ranks2, ranks4, data):
    n_data, n_model, fsdp, experts = LAYOUTS[layout]
    jcfg = _jax_cfg(experts)
    params, want = _jax_int8(jcfg, n_data, n_model, fsdp, data)
    cfg = _port_cfg(jcfg)
    sig, lab, signals = data
    split = SplitData(sig, lab)
    tcfg = TrainConfig(**KW, mesh_model=n_model, fsdp=fsdp)
    ranks = ranks2 if n_data * n_model == 2 else ranks4
    out = ranks.run(prog.int8_serving, cfg, tcfg, (n_data, n_model), params, signals, split)
    one = prog.int8_serving(cfg, TrainConfig(**KW), None, params, signals, split)
    got = out[0]
    _close(got['int8'], want)
    _close(got['int8'], one['int8'])
    assert got['summary'] == one['summary'] and got['summary']['compression'] > 2
    for r in out:   # every rank serves the same answers; disable is exact
        assert all(np.array_equal(a, b) for a, b in zip(r['int8'], got['int8']))
        assert all(np.array_equal(a, b) for a, b in zip(r['after'], r['before']))
    full = {k: tuple(v.shape) for k, v in EcgVit(cfg).state_dict().items()}
    assert got['rest_shapes'] == {k: full[k] for k in got['rest_shapes']}
    assert len(got['rest_shapes']) < len(full)
    assert got['model_bytes'] == 4 * sum(int(np.prod(full[k])) for k in got['rest_shapes'])


def test_int8_on_a_mesh_serves_the_gathered_ema(ranks2, data):
    sig, lab, signals = data
    split = SplitData(sig, lab)
    cfg = _port_cfg(_jax_cfg(0))
    tcfg = TrainConfig(**KW, fsdp=True, ema_decay=0.5)
    out = ranks2.run(prog.int8_serving, cfg, tcfg, (2, 1), None, signals, split, 2)
    got = out[0]
    assert not np.array_equal(got['int8'][0], got['before'][0])
    # the one-device int8 of the gathered EMA, installed as plain params
    from ecg_representation_learning_tpu_torch.models.port import flax_params_from_state_dict
    one = prog.int8_serving(cfg, TrainConfig(**KW), None,
                            flax_params_from_state_dict(got['served']), signals, split)
    _close(got['int8'], one['int8'])
    assert all(np.array_equal(a, b) for a, b in zip(got['after'], got['before']))


def test_cli_infer_int8_on_two_ranks_writes_the_one_device_codes(tmp_path, capsys):
    cli.main(['synth', '--n', '24', '--out', str(tmp_path / 'd')])
    h5 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])['hdf5']
    base = ['infer', '--size', 'debug', '--no-bf16', '--hdf5', h5, '--int8',
            '--batch-size', '8', '--top-k', '3']
    cli.main(['--platform', 'cpu', *base, '--out', str(tmp_path / 'one.json')])
    cli.main(['--platform', 'cpu', '--host-devices', '2', *base,
              '--out', str(tmp_path / 'two.json')])
    one, two = (json.loads((tmp_path / f).read_text()) for f in ('one.json', 'two.json'))
    assert one['n_records'] == two['n_records'] == 24
    for a, b in zip(one['records'], two['records']):
        assert [t['code'] for t in a['top']] == [t['code'] for t in b['top']]
        np.testing.assert_allclose([t['prob'] for t in a['top']],
                                   [t['prob'] for t in b['top']], rtol=0, atol=TOL)


def test_serve_int8_on_a_mesh_answers_each_client_as_one_device(ranks2, data):
    jcfg = _jax_cfg(0)
    params, _ = _jax_int8(jcfg, 2, 1, False, data)
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(12)
    requests = [(0.5 * rng.standard_normal((n, 12, 250))).astype(np.float32)
                for n in (1, 2, 1, 3, 1, 1)]
    out = ranks2.run(prog.serve_on_mesh, cfg, TrainConfig(**KW), (2, 1), params, requests)
    (probs, health), followed = out
    assert health['requests'] == len(requests) + 1   # + the warm-up request
    assert followed == health['dispatches']
    from ecg_representation_learning_tpu_torch.models.port import state_dict_from_flax
    one = Trainer(cfg, TrainConfig(**KW), device='cpu')
    one.set_params(state_dict_from_flax(params, EcgVit(cfg)))
    one.enable_int8_inference()
    for sig, got in zip(requests, probs):
        np.testing.assert_allclose(got, one.predict(sig), rtol=0, atol=TOL)


def test_serve_on_a_mesh_answers_past_a_failing_batch(ranks2):
    cfg = _port_cfg(_jax_cfg(0))
    one = Trainer(cfg, TrainConfig(**KW), device='cpu')
    one.init_state()
    params = one.state_dict()
    one.enable_int8_inference()
    rng = np.random.default_rng(13)
    bad, good = ((0.5 * rng.standard_normal((n, 12, length))).astype(np.float32)
                 for n, length in ((1, 100), (2, 250)))
    (status, probs, health), followed = ranks2.run(
        prog.serve_past_a_failing_batch, cfg, TrainConfig(**KW), (2, 1), params, bad, good)
    assert status == 400
    assert health['requests'] == 3                   # the warm-up, bad, good
    assert followed == health['dispatches'] == 3
    np.testing.assert_allclose(probs, one.predict(good), rtol=0, atol=TOL)
