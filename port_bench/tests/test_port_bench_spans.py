"""The readers of the program's spans and phase marks (``span_readers.py``)
in a toy traced run of ``vitb_cls_k4`` on the CPU, and their silence on a
program without the recorder."""
from __future__ import annotations

import sys
import types

from conftest import toy_run

PHASE_METRICS = ('step_forward_ms.train', 'step_backward_ms.train', 'step_update_ms.train')


def test_traced_toy_run_reports_the_span_metrics():
    from ecg_representation_learning_tpu_torch.utils import tracing
    tracing.reset()
    out, _ = toy_run('vitb_cls_k4', trace=True)
    assert out['correct'] is True, out['checks']
    m = out['metrics']
    for name in PHASE_METRICS + ('dispatch_host_ms.train',):
        assert m[name]['unit'] == 'ms' and m[name]['value'] > 0, name
    assert 'dispatch_gap_ms.train' not in m       # no gap off the card


def test_readers_return_none_without_the_recorder(monkeypatch):
    from ecg_representation_learning_tpu_torch import utils
    from port_bench import span_readers
    monkeypatch.delattr(utils, 'tracing')
    monkeypatch.setitem(sys.modules, 'ecg_representation_learning_tpu_torch.utils.tracing', None)
    run = types.SimpleNamespace(device='cuda:0')
    for read in (span_readers.step_forward_ms, span_readers.dispatch_gap_ms,
                 span_readers.dispatch_host_ms):
        assert read(run) is None
