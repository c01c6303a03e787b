"""Shared fixtures of the benchmark's CPU tests: toy-size runs of a cell."""
from __future__ import annotations

import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

TINY = {'hidden_size': 64, 'num_hidden_layers': 2, 'num_attention_heads': 4,
        'intermediate_size': 128, 'dtype': 'float32'}
TOY_TRAFFIC = {
    'vitb_cls_k4': {'train_records': 300, 'batch_size': 8},
    'vitb_cls_eager': {'train_records': 300, 'batch_size': 8},
    'vitb_mae_stream': {'batch_size': 8, 'corpora': [
        {'name': 'a', 'fqs': 500, 'samples': 5000, 'weight': 0.9, 'shards': 2,
         'records_per_shard': 16},
        {'name': 'b', 'fqs': 400, 'samples': 4096, 'weight': 0.1, 'shards': 2,
         'records_per_shard': 8}]},
    'vitb_serve_poisson': {'rate_per_s': 20.0, 'pool_rest': 8, 'pool_long': 2,
                           'check_sample': 8},
}


def toy_run(workload: str, seed: int = 2 ** 31 + 7, trace: bool = False, seconds: float = 1.5,
            overrides=None):
    """A toy-size run of ``workload`` on the CPU (``overrides``: more traffic
    keys): (result line, the run)."""
    import torch
    from port_bench import harness
    r = harness.Run(workload=workload, seed=seed, seconds=seconds, trace=trace,
                    device=torch.device('cpu'), t_process=time.perf_counter(),
                    overrides={'config': TINY,
                               'traffic': {**TOY_TRAFFIC[workload], **(overrides or {})}})
    return harness.execute(r), r


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    """Each test's runs write under its own temporary directory."""
    import tempfile
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA device (skips without one)')
