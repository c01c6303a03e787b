"""The plain reference against the port's plain path at a tiny size, the
frozen FLOP count against the port's, and the imports: nothing under
``port_bench`` loads JAX or the JAX package, and the reference loads nothing
of the port either (module names compared whole)."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from conftest import TINY
from port_bench import harness, inputs, yardstick
from port_bench.reference import model as ref

ROOT = harness.ROOT


def _cfg(name):
    return {**harness.load_json('configs', f'{name}.json'), **TINY}


def test_vit_logits_match_the_port():
    from ecg_representation_learning_tpu_torch.models.vit import EcgVit
    from port_bench.drivers.train import vit_config
    cfg = _cfg('vit-base-ptbxl')
    w = inputs.weights(ref.vit_shapes(cfg), 5, 'cpu')
    model = EcgVit(vit_config(cfg)).eval()
    model.load_state_dict(w, strict=True)
    x = torch.randn(3, 12, 2560)
    with torch.no_grad():
        want = model(x).logits
        got = ref.vit_logits(w, x, cfg)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mae_parameters_match_the_port():
    from ecg_representation_learning_tpu_torch.models.mae import EcgMae
    from port_bench.drivers.mae_stream import mae_config
    from port_bench.drivers.train import vit_config
    cfg = _cfg('vit-base-mae-stream')
    model = EcgMae(vit_config(cfg), mae_config(cfg))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == ref.mae_shapes(cfg)


@pytest.mark.parametrize('name', ['vit-base-ptbxl', 'vit-base-mae-stream'])
def test_preprocess_reference_matches_the_port(name):
    import numpy as np
    from ecg_representation_learning_tpu_torch.ops.preprocess import fused_train_path
    from port_bench.reference.preprocess import model_input
    cfg = harness.load_json('configs', f'{name}.json')
    rng = np.random.default_rng(0)
    counts = (rng.standard_normal((2, 12, 5000)) * 300).astype(np.int16)
    want = model_input(counts, 500, 1000.0, cfg['norm_stats'], 64, 2560)
    got = fused_train_path(torch.tensor(counts).float() / 1000.0,
                           torch.tensor(cfg['norm_stats']['mean']),
                           torch.tensor(cfg['norm_stats']['std']), fqs=500)[..., :2560]
    assert np.abs(got.numpy() - want).max() < 1e-3 * np.abs(want).max()


def test_frozen_flops_equal_the_ports():
    from ecg_representation_learning_tpu_torch.models.vit import train_step_flops_per_sample
    from port_bench.drivers.train import vit_config
    cfg = harness.load_json('configs', 'vit-base-ptbxl.json')
    assert yardstick.train_flops_per_sample(cfg) == train_step_flops_per_sample(vit_config(cfg))


def _modules_after(imports):
    code = ('import sys; sys.path.insert(0, %r)\n' % ROOT
            + ''.join(f'import {m}\n' for m in imports)
            + 'print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


def _port_bench_modules():
    mods = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, 'port_bench')):
        rel = os.path.relpath(dirpath, ROOT)
        if 'tests' in rel.split(os.sep) or 'metrics' in rel.split(os.sep):
            continue
        mods += [rel.replace(os.sep, '.') + '.' + f[:-3] for f in files
                 if f.endswith('.py') and f != '__init__.py']
    return mods


def test_harness_loads_no_jax():
    mods = _port_bench_modules()
    assert 'port_bench.run' in mods and 'port_bench.reference.model' in mods
    loaded = _modules_after(mods + ['ecg_representation_learning_tpu_torch.train',
                                    'ecg_representation_learning_tpu_torch.train.dispatch',
                                    'ecg_representation_learning_tpu_torch.serving',
                                    'ecg_representation_learning_tpu_torch.data.pipeline',
                                    'ecg_representation_learning_tpu_torch.ops.preprocess'])
    assert not loaded & set(harness.FORBIDDEN)
    assert 'ecg_representation_learning_tpu' not in loaded


def test_reference_loads_nothing_of_the_port():
    loaded = _modules_after(['port_bench.reference.model', 'port_bench.reference.preprocess'])
    assert not loaded & (set(harness.FORBIDDEN) | {'ecg_representation_learning_tpu_torch'})
