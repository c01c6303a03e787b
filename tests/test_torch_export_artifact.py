"""The port's serving artifact (models/export_artifact.py) and the op
``ecg_tpu_torch::flash_fwd`` it holds, on the CPU.

The five cases of ``tests/test_export_artifact.py`` (round trip, short-record
padding, non-zero-mean stats, int8, metadata), held against the JAX
``Trainer.predict`` on the same weights (JAX init, carried over through
``models/port``) at 1e-5, the bar of
``tests/test_torch_serving.py::test_predict_matches_jax``.  The port runs
flash attention through its op (``flash_min_seq=0``), the JAX side its XLA
attention, the same function.  Then: the exported graph keeps one op node per
layer and no softmax; a fresh interpreter loads the artifact with only the
op's module imported; the op's CPU kernel is the plain version; a MoE model
is refused by both packages.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ecg_representation_learning_tpu.configs import TrainConfig as JaxTrainConfig
from ecg_representation_learning_tpu.configs import VitConfig as JaxVitConfig
from ecg_representation_learning_tpu.models.export_artifact import \
    export_model as jax_export_model
from ecg_representation_learning_tpu.train import trainer as jtrainer
from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.models.export_artifact import (ExportedModel,
                                                                          export_model)
from ecg_representation_learning_tpu_torch.models.port import vit_state_dict_from_flax
from ecg_representation_learning_tpu_torch.ops import attention as A
from ecg_representation_learning_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _signals(seed, n, length=640):
    return (0.2 * np.random.default_rng(seed).standard_normal((n, 12, length))
            ).astype(np.float32)


def _pair(stats=None, **port_overrides):
    """(JAX Trainer, port Trainer) of a debug ViT at 704 samples with one set
    of weights."""
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=704,
                                     use_flash_attention=False)
    jtr = jtrainer.Trainer(jcfg, JaxTrainConfig(eval_batch_size=8, log_to_console=False),
                           norm_stats=stats)
    jtr.init_state()
    params = jax.tree.map(np.asarray, jtr.state.params)
    cfg = VitConfig(**{**dataclasses.asdict(jcfg), 'use_flash_attention': True,
                       'flash_min_seq': 0, **port_overrides})
    tr = ttrainer.Trainer(cfg, TrainConfig(eval_batch_size=8, log_to_console=False),
                          norm_stats=stats, device='cpu')
    tr.set_params(vit_state_dict_from_flax(params, cfg))
    return jtr, tr


@pytest.fixture(scope='module')
def pair():
    return _pair()


@pytest.fixture(scope='module')
def artifact(pair, tmp_path_factory):
    path = str(tmp_path_factory.mktemp('artifact'))
    return path, export_model(pair[1], path)


def test_export_roundtrip_parity(pair, artifact):
    jtr, tr = pair
    path, meta = artifact
    assert os.path.exists(os.path.join(path, 'model.pt2'))
    assert meta['wire']['signal_length'] == 640    # 704 - patch 64
    assert meta['model_config']['num_class'] == tr.model_cfg.num_class
    m = ExportedModel.load(path, device='cpu')
    x = _signals(0, 8)
    probs = m.predict(x)
    ref = jtr.predict(x)
    assert probs.shape == ref.shape
    np.testing.assert_allclose(probs, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(probs, tr.predict(x), atol=TOL, rtol=0)
    # symbolic batch: any request size runs through the one artifact
    assert m.predict(x[:3]).shape == (3, tr.model_cfg.num_class)
    np.testing.assert_allclose(m.predict(x[0]), ref[:1], atol=TOL, rtol=0)


def test_export_short_record_padding(pair, artifact):
    jtr, tr = pair
    m = ExportedModel.load(artifact[0], device='cpu')
    short = _signals(1, 2, 500)
    probs = m.predict(short)
    assert probs.shape == (2, tr.model_cfg.num_class)
    assert np.isfinite(probs).all() and (probs <= 1).all()
    # zero stats: the mean pad is zeros, where Trainer.predict lands too
    full = np.concatenate([short, np.zeros((2, 12, 140), np.float32)], axis=2)
    np.testing.assert_allclose(probs, jtr.predict(full), atol=TOL, rtol=0)
    # too-long records are refused with windowing advice, not truncated
    with pytest.raises(AssertionError, match='wire length'):
        m.predict(np.zeros((1, 12, 4096), np.float32))


def test_export_short_record_nonzero_mean_stats(tmp_path):
    # with non-zero per-lead means the host-side pad must use the MEAN, not
    # raw zeros: the program normalizes before its own time_end_pad
    stats = {'mean': [0.5 + 0.05 * i for i in range(12)],
             'std': [0.2 + 0.01 * i for i in range(12)]}
    jtr, tr = _pair(stats)
    export_model(tr, str(tmp_path))
    m = ExportedModel.load(str(tmp_path), device='cpu')
    short = _signals(2, 2, 500)
    mean = np.asarray(stats['mean'], np.float32).reshape(1, 12, 1)
    full = np.concatenate(
        [short, np.broadcast_to(mean, (2, 12, m.signal_length - 500))], axis=2)
    np.testing.assert_allclose(m.predict(short), m.predict(full), atol=1e-6, rtol=0)
    np.testing.assert_allclose(m.predict(full), jtr.predict(full), atol=TOL, rtol=0)


def test_export_int8_artifact(pair, artifact, tmp_path):
    jtr, tr = pair
    meta8 = export_model(tr, str(tmp_path), int8=True)
    # int8 weights ~4x smaller; the debug model is tiny so just require a
    # real reduction (the JAX case's bar)
    assert meta8['bytes'] < artifact[1]['bytes'] * 0.55
    m8 = ExportedModel.load(str(tmp_path), device='cpu')
    int8 = [k for k, v in m8.program.state_dict.items() if v.dtype == torch.int8]
    assert len(int8) == 1 + 4 * 4 + 1   # patch projection, qkv/out/fc1/fc2 per layer, head
    x = _signals(3, 8)
    probs = m8.predict(x)
    assert np.abs(probs - jtr.predict(x)).max() < 0.05
    # the same quantized weights as the JAX package's int8 inference
    jtr.enable_int8_inference()
    try:
        np.testing.assert_allclose(probs, jtr.predict(x), atol=TOL, rtol=0)
    finally:
        jtr.disable_int8_inference()


def test_export_metadata_classes(pair, artifact):
    path, meta = artifact
    with open(os.path.join(path, 'metadata.json')) as f:
        on_disk = json.load(f)
    assert on_disk == meta
    assert len(meta['classes']) == min(pair[1].model_cfg.num_class, 71)
    assert all({'id', 'code', 'description'} <= set(c) for c in meta['classes'])
    assert meta['norm_stats']['mean'] == [0.0] * 12
    assert meta['platforms'] == ['cpu'] and meta['traced_on'] == 'cpu'
    assert meta['torch_version'] == torch.__version__ and 'jax_version' not in meta
    assert meta['bytes'] == os.path.getsize(os.path.join(path, 'model.pt2'))
    assert 'ops.attention' in meta['load_needs']


def test_export_serves_the_ema_weights(tmp_path):
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=704)
    cfg = VitConfig(**{**dataclasses.asdict(jcfg), 'flash_min_seq': 0})
    tr = ttrainer.Trainer(cfg, TrainConfig(ema_decay=0.9), device='cpu')
    tr.init_state()
    with torch.no_grad():
        for v in tr.ema.values():
            v.mul_(0.5)
    export_model(tr, str(tmp_path))
    x = _signals(4, 4)
    got = ExportedModel.load(str(tmp_path), device='cpu').predict(x)
    np.testing.assert_allclose(got, tr.predict(x), atol=TOL, rtol=0)
    tr.ema = None
    assert np.abs(got - tr.predict(x)).max() > 1e-3


def _graph_ops(path):
    ep = ExportedModel.load(path, device='cpu').program
    return [str(n.target) for n in ep.graph.nodes if n.op == 'call_function']


@pytest.mark.parametrize('flash', [True, False])
def test_exported_graph_holds_the_flash_op(flash, pair, artifact, tmp_path):
    """With flash on (``flash_min_seq=0``) one op node per layer and no
    softmax; at the default ``flash_min_seq`` (128 > 11 tokens) the plain
    softmax attention, as JAX exports it."""
    cfg = pair[1].model_cfg
    path = artifact[0]
    if not flash:
        tr = ttrainer.Trainer(dataclasses.replace(cfg, flash_min_seq=128), TrainConfig(),
                              device='cpu')
        tr.init_state()
        export_model(tr, str(tmp_path))
        path = str(tmp_path)
    ops = _graph_ops(path)
    n_op = sum(t == 'ecg_tpu_torch.flash_fwd.default' for t in ops)
    n_softmax = sum('softmax' in t for t in ops)
    layers = cfg.num_hidden_layers
    assert (n_op, n_softmax) == ((layers, 0) if flash else (0, layers))


def test_artifact_loads_in_a_fresh_interpreter(artifact):
    """Only the op's module is imported: no model code, config or checkpoint."""
    path, _ = artifact
    code = f'''
import json, sys
import numpy as np, torch
import ecg_representation_learning_tpu_torch.ops.attention
ep = torch.export.load({os.path.join(path, "model.pt2")!r})
x = (0.2 * np.random.default_rng(5).standard_normal((5, 12, 640))).astype(np.float32)
with torch.no_grad():
    one = ep.module()(torch.from_numpy(x[:1])).numpy().tolist()
    five = ep.module()(torch.from_numpy(x)).numpy().tolist()
models = sorted(m for m in sys.modules if '.models' in m and 'ecg_' in m)
print(json.dumps({{'one': one, 'five': five, 'models': models}}))
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out['models'] == []
    x = _signals(5, 5)
    want = ExportedModel.load(path, device='cpu').predict(x)
    np.testing.assert_allclose(np.asarray(out['five']), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(out['one']), want[:1], atol=1e-6, rtol=0)


def test_load_refuses_an_unlisted_device(artifact):
    with pytest.raises(ValueError, match='checked on'):
        ExportedModel.load(artifact[0], device='cuda')
    with pytest.raises(ValueError, match='checked on'):
        ExportedModel.load(artifact[0])          # the default is the GPU


@pytest.mark.parametrize('rate', [0.0, 0.25])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_op_cpu_kernel_is_the_plain_version(rate, dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 17, 16, generator=g).to(dtype) for _ in range(3))
    got = torch.ops.ecg_tpu_torch.flash_fwd(q, k, v, 7, 0.25, rate)
    want = A.flash_attention_forward_reference(q, k, v, 7, 0.25, rate)
    assert torch.equal(got, want)


def test_op_refuses_what_the_binding_refuses_and_unknown_devices():
    q = torch.randn(1, 2, 5, 8)
    op = torch.ops.ecg_tpu_torch.flash_fwd.default
    with pytest.raises(ValueError, match='contiguous'):
        op(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3), 0, 0.3, 0.0)
    with pytest.raises(ValueError, match='seed'):
        op(q, q, q, -1, 0.3, 0.0)
    with pytest.raises(ValueError, match='dropout_rate'):
        op(q, q, q, 0, 0.3, 1.0)
    # a backend with no kernel (here XPU's dispatch key) reaches the op's body
    keys = torch._C.DispatchKeySet(torch._C.DispatchKey.XPU)
    with pytest.raises(RuntimeError, match='no kernel'):
        op.redispatch(keys, q, q, q, 0, 0.3, 0.0)
    # the fake: shapes only, no data pointer
    qm = torch.empty(4, 2, 5, 8, device='meta')
    assert op(qm, qm, qm, 0, 0.3, 0.0).shape == qm.shape


def test_moe_is_refused_by_both_packages(tmp_path):
    """JAX cannot export a MoE ViT with a symbolic batch (its capacity
    ceil(cf * S / E) meets a symbolic S); the port refuses it up front."""
    jcfg = JaxVitConfig.from_defined('debug', max_signal_length=704,
                                     use_flash_attention=False, moe_num_experts=2)
    jtr = jtrainer.Trainer(jcfg, JaxTrainConfig(log_to_console=False))
    jtr.init_state()
    with pytest.raises(TypeError, match='Fraction'):
        jax_export_model(jtr, str(tmp_path / 'jax'))
    cfg = VitConfig(**{**dataclasses.asdict(jcfg), 'flash_min_seq': 0})
    tr = ttrainer.Trainer(cfg, TrainConfig(), device='cpu')
    tr.init_state()
    with pytest.raises(ValueError, match='Switch-MoE'):
        export_model(tr, str(tmp_path / 'port'))
    assert not os.path.exists(tmp_path / 'port')
