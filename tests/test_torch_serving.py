"""The port's serving path (train/trainer.py, serving.py, cli.py) on the CPU.

``Trainer.predict``/``predict_long`` are held against the JAX ``Trainer``
with the same params and normalization stats; the service and HTTP cases
port ``tests/test_serving.py``.  The port runs attention through the flash
kernel's plain version (``flash_min_seq=0``); the JAX side runs its XLA
attention, the same function.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu import registry as jregistry
from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.train import trainer as jtrainer
from ecg_representation_learning_tpu_torch import cli, registry, runtime
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.port import vit_state_dict_from_flax
from ecg_representation_learning_tpu_torch.serving import InferenceService, serve
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

STATS = registry.PTBXL_TRAIN_STATS['original']


@pytest.fixture(scope='module')
def pair():
    """(JAX Trainer, port Trainer) with one set of weights."""
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
    return jtr, tr


@pytest.fixture(scope='module')
def trainer(pair):
    return pair[1]


def _signals(seed, n, length):
    # raw-scale ECG: ~0.2 mV per lead, as the normalization stats expect
    return (0.2 * np.random.default_rng(seed).standard_normal((n, 12, length))
            ).astype(np.float32)


@pytest.mark.parametrize('length', [250, 2500, 2560])
def test_prep_batch_matches_jax(length):
    sig = _signals(4, 3, length)
    want = np.asarray(jtrainer._prep_batch(
        jnp.asarray(sig), jnp.asarray(STATS['mean'], jnp.float32),
        jnp.asarray(STATS['std'], jnp.float32), 64, train=False))
    got = ttrainer._prep_batch(torch.from_numpy(sig),
                               torch.tensor(STATS['mean'], dtype=torch.float32),
                               torch.tensor(STATS['std'], dtype=torch.float32), 64)
    assert got.shape[-1] == length + 64 - length % 64   # the always-pad quirk
    np.testing.assert_array_equal(got.numpy(), want)


def test_predict_matches_jax(pair):
    jtr, tr = pair
    sig = _signals(0, 11, 250)                 # 11 = one full batch + a padded one
    np.testing.assert_allclose(tr.predict(sig), jtr.predict(sig), atol=1e-5, rtol=0)


@pytest.mark.parametrize('agg', ['max', 'mean'])
@pytest.mark.parametrize('length', [250, 320, 900])   # direct; 2 windows; 6 windows
def test_predict_long_matches_jax(pair, length, agg):
    jtr, tr = pair
    sig = _signals(length, 3, length)
    got = tr.predict_long(sig, agg=agg)
    assert got.shape == (3, tr.model_cfg.num_class)
    np.testing.assert_allclose(got, jtr.predict_long(sig, agg=agg), atol=1e-5, rtol=0)


def test_init_state_is_seeded_and_follows_flax_distributions():
    cfg = VitConfig.from_defined('debug', max_signal_length=320)
    a = ttrainer.Trainer(cfg, TrainConfig(), device='cpu').init_state(seed=3)
    b = ttrainer.Trainer(cfg, TrainConfig(), device='cpu').init_state(seed=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    fc1 = a['encoder.blocks.0.mlp.fc1.weight']          # lecun normal, fan_in 64
    assert abs(fc1.std().item() - 64 ** -0.5) < 0.01
    assert fc1.abs().max().item() <= 2 * 64 ** -0.5 / 0.87962566103423978
    assert abs(a['encoder.pos_embed'].std().item() - 0.02) < 0.002
    assert torch.equal(a['encoder.final_norm.weight'], torch.ones(64))
    assert not a['head.bias'].any()


def test_trainer_needs_a_device_or_an_explicit_cpu(monkeypatch):
    cfg = VitConfig.from_defined('debug', max_signal_length=320)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttrainer.Trainer(cfg, TrainConfig())
    assert runtime.default_device('cpu') == torch.device('cpu')
    tr = ttrainer.Trainer(cfg, TrainConfig(), device='cpu')
    with pytest.raises(RuntimeError, match='init_state'):
        tr.predict(_signals(0, 1, 250))


def test_registry_copy_equals_the_jax_registry():
    assert registry.PTBXL_ID2CODE == jregistry.PTBXL_ID2CODE
    assert registry.PTBXL_CODE2DESCRIPTION == jregistry.PTBXL_CODE2DESCRIPTION
    assert registry.PTBXL_TRAIN_STATS == jregistry.PTBXL_TRAIN_STATS
    assert registry.PTBXL_N_CLASS == jregistry.PTBXL_N_CLASS == 71


# --- service and HTTP: ports of tests/test_serving.py -------------------------

def test_service_predict_shapes_and_topk(trainer):
    svc = InferenceService(trainer)
    out = svc.predict({'signals': _signals(0, 3, 250).tolist(), 'top_k': 4})
    probs = np.asarray(out['probs'])
    assert probs.shape == (3, trainer.model_cfg.num_class)
    assert np.all((probs >= 0) & (probs <= 1))
    assert len(out['top']) == 3 and len(out['top'][0]) == 4
    for i, row in enumerate(out['top']):
        assert set(row[0]) == {'code', 'description', 'prob'}
        p = [e['prob'] for e in row]
        assert p == sorted(p, reverse=True)
        assert row[0]['prob'] == pytest.approx(float(probs[i].max()), abs=1e-5)
        assert row[0]['code'] == registry.PTBXL_ID2CODE[int(probs[i].argmax())]
    svc.close()


def test_service_single_record_and_validation(trainer):
    svc = InferenceService(trainer)
    out = svc.predict({'signals': _signals(1, 1, 250)[0].tolist()})
    assert np.asarray(out['probs']).shape[0] == 1
    with pytest.raises(ValueError, match='leads'):
        svc.predict({'signals': np.zeros((1, 3, 250)).tolist()})
    with pytest.raises(ValueError, match='N, C, L'):
        svc.predict({'signals': [1.0, 2.0]})
    with pytest.raises(ValueError, match='agg'):
        svc.predict({'signals': _signals(1, 1, 250).tolist(), 'agg': 'sum'})
    with pytest.raises(ValueError, match='JSON object'):
        svc.predict([1, 2])
    svc.close()


def test_service_long_record_auto_windows(trainer):
    svc = InferenceService(trainer)
    x = _signals(7, 1, 900)
    for agg in ('max', 'mean'):
        out = svc.predict({'signals': x.tolist(), 'agg': agg})
        want = trainer.predict_long(x, agg=agg)
        np.testing.assert_allclose(np.asarray(out['probs']), np.round(want, 6),
                                   atol=1e-6)
    svc.close()


def test_microbatcher_coalesces_concurrent_requests(trainer):
    """32 concurrent batch-1 clients each get exactly their own row, over
    fewer device dispatches than requests."""
    svc = InferenceService(trainer, max_wait_ms=200.0)
    sigs = _signals(11, 32, 250)
    want = trainer.predict(sigs)
    got = [None] * 32
    errs = []

    def client(i):
        try:
            got[i] = np.asarray(svc.predict({'signals': sigs[i].tolist()})['probs'])[0]
        except Exception as e:              # pragma: no cover - fail below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    for i in range(32):
        np.testing.assert_allclose(got[i], np.round(want[i], 6), atol=2e-6,
                                   err_msg=f'client {i} got another row')
    assert svc.batcher.dispatches < svc.batcher.requests == 32
    svc.close()


def test_microbatcher_mixed_lengths_and_error_fanout(trainer):
    svc = InferenceService(trainer, max_wait_ms=100.0)
    a, b = _signals(13, 1, 250), _signals(14, 1, 200)
    out = {}

    def client(key, x):
        out[key] = np.asarray(svc.predict({'signals': x.tolist()})['probs'])

    ts = [threading.Thread(target=client, args=('a', a)),
          threading.Thread(target=client, args=('b', b))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    np.testing.assert_allclose(out['a'], np.round(trainer.predict(a), 6), atol=2e-6)
    np.testing.assert_allclose(out['b'], np.round(trainer.predict(b), 6), atol=2e-6)

    orig = trainer.predict_long
    trainer.predict_long = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError('device fault (simulated)'))
    try:
        with pytest.raises(RuntimeError, match='device fault'):
            svc.predict({'signals': a.tolist()})
    finally:
        trainer.predict_long = orig
    ok = svc.predict({'signals': a.tolist()})
    np.testing.assert_allclose(np.asarray(ok['probs']),
                               np.round(trainer.predict(a), 6), atol=2e-6)
    svc.close()
    with pytest.raises(RuntimeError, match='closed'):
        svc.predict({'signals': a.tolist()})


def _post(port, body: bytes, timeout=120):
    req = urllib.request.Request(f'http://127.0.0.1:{port}/predict', data=body,
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_http_round_trip(trainer):
    httpd = serve(trainer, port=0)              # port 0: OS-assigned; warms up
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/health', timeout=30) as r:
            health = json.loads(r.read())
        assert health['status'] == 'ok'
        assert health['num_class'] == trainer.model_cfg.num_class
        assert health['dispatches'] == 1        # the warmup request
        x = _signals(2, 2, 250)
        out = _post(port, json.dumps({'signals': x.tolist()}).encode())
        np.testing.assert_allclose(np.asarray(out['probs']),
                                   np.round(trainer.predict(x), 6), atol=2e-6)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, b'{"signals": [1]}', timeout=30)
        assert ei.value.code == 400
        with urllib.request.urlopen(f'http://127.0.0.1:{port}/health', timeout=30) as r:
            assert json.loads(r.read())['status'] == 'ok'
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
        t.join(timeout=30)


def test_http_server_fault_maps_to_500(trainer):
    httpd = serve(trainer, port=0, warmup=False)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    orig = httpd.service.trainer.predict_long

    def boom(*a, **k):
        raise RuntimeError('CUDA error: out of memory (simulated)')

    try:
        httpd.service.trainer.predict_long = boom
        body = json.dumps({'signals': _signals(3, 1, 250).tolist()}).encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, body, timeout=30)
        assert ei.value.code == 500
        assert 'out of memory' in json.loads(ei.value.read())['error']
        with pytest.raises(urllib.error.HTTPError) as ei2:
            _post(port, b'not json', timeout=30)
        assert ei2.value.code == 400
    finally:
        httpd.service.trainer.predict_long = orig
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
        t.join(timeout=30)


def test_cli_serve_flags():
    args = cli.build_parser().parse_args(
        ['serve', '--size', 'debug', '--no-bf16', '--stats', 'original',
         '--batch-size', '8', '--host', '127.0.0.1', '--port', '0'])
    assert (args.size, args.bf16, args.stats, args.batch_size, args.port) == (
        'debug', False, 'original', 8, 0)
    assert args.fn is cli.cmd_serve
    help_text = cli.build_parser()._subparsers._group_actions[0].choices['serve'].format_help()
    assert 'checkpoint' in help_text
