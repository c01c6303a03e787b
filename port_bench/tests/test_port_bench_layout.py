"""BENCHMARK.json resolves, cell by cell and metric by metric, to the
harness's own files, and keeps to the contract's names and limits."""
from __future__ import annotations

import json
import os
import re

import pytest

from port_bench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
BENCH = harness.benchmark()


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_cell_resolves(cell):
    entry, c, config, traffic = harness.resolve(cell)
    assert (c['config'], c['traffic']) == (entry['config'], entry['traffic'])
    e2e, layer = harness.metric_lists(cell)
    names = {m['name'] for m in e2e}
    assert 'setup_s' in names and len(names) >= 2 and layer
    assert all(m['moves'] in names for m in layer)


@pytest.mark.parametrize('cell', harness.cells())
def test_cell_file_resolves(cell):
    _, c, config, traffic = harness.resolve(cell)
    assert os.path.isfile(os.path.join(harness.HERE, 'drivers', f'{traffic["driver"]}.py'))
    assert set(c['limits']) and all(v > 0 for v in c['limits'].values())
    assert config['source'] and traffic['why']


@pytest.mark.parametrize('config', BENCH['configs'], ids=lambda c: c['name'])
def test_config_resolves(config):
    path = os.path.join(harness.ROOT, config['file'])
    with open(path) as f:
        body = json.load(f)
    assert body['source'] == config['source']
    assert body['reduced'] == config['reduced'] == []
    assert any(w['config'] == config['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('metric', BENCH['per_layer'], ids=lambda m: m['name'])
def test_metric_reader_exists(metric):
    path = os.path.join(harness.HERE, 'metrics', f'{metric["name"]}.py')
    assert os.path.isfile(path)
    assert metric['layer'] and '\n' not in metric['layer']


def test_names_units_and_bounds():
    names = ([m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
             + [w['name'] for w in BENCH['workloads']] + [c['name'] for c in BENCH['configs']])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert re.match(r'^[A-Za-z0-9_/%.-]{1,16}$', m['unit'])
        assert m['better'] in ('lower', 'higher')
    assert all(w['chips'] == 1 for w in BENCH['workloads'])
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
