"""Toy-size runs of every cell on the CPU: the result line's keys, the
check's verdict on the unbroken program, and the check catching each fault
a cell can have when the timed path is broken underneath it; the command
line refusing a machine without the card; and, on a card, a short run of
each cell."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import toy_run
from port_bench import harness

CELLS = harness.cells()
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('trace', [False, True])
def test_toy_run_result_line(cell, trace):
    out, _ = toy_run(cell, trace=trace)
    assert list(out)[:5] == KEYS and list(out)[-1] == 'checks'
    assert set(out) <= set(KEYS) | {'breakdown', 'checks'}
    assert out['correct'] is True, out['checks']
    assert out['attempted'] > 0 and out['failed'] == 0
    e2e, _ = harness.metric_lists(cell)
    if not trace:
        assert set(out['metrics']) == {m['name'] for m in e2e}
    json.loads(json.dumps(out))


def _unchanged_state(monkeypatch):
    """Every optimizer step leaves the parameters as they were."""
    from ecg_representation_learning_tpu_torch.train import trainer as mod
    import torch

    def update(self, grads, scalars=None):
        self.step += 1
        for p in self.params().values():
            p.grad = None
        return torch.zeros((), device=self.device)
    monkeypatch.setattr(mod.TrainerBase, '_update', update)


def _half_batch(monkeypatch, cell):
    """The loss of every step is the mean over the first half of its batch."""
    if cell == 'vitb_mae_stream':
        from ecg_representation_learning_tpu_torch.models import mae
        inner = mae.EcgMae.forward

        def forward(self, x, *a, **kw):
            out = inner(self, x, *a, **kw)
            out.loss = out.per_sample_loss[:x.shape[0] // 2].mean()
            return out
        monkeypatch.setattr(mae.EcgMae, 'forward', forward)
    else:
        from ecg_representation_learning_tpu_torch.models import vit
        inner = vit.bce_with_logits

        def bce(logits, labels, **kw):
            n = logits.shape[0] // 2
            return inner(logits[:n], labels[:n], **kw)
        monkeypatch.setattr(vit, 'bce_with_logits', bce)


def _altered_answer(monkeypatch):
    """The served probabilities are altered where they are produced."""
    from ecg_representation_learning_tpu_torch.train import trainer as mod
    inner = mod.Trainer.predict

    def predict(self, signals):
        return np.clip(inner(self, signals) + 0.1, 0.0, 1.0)
    monkeypatch.setattr(mod.Trainer, 'predict', predict)


FAULTS = [(c, f) for c in CELLS for f in
          (('altered_answer',) if c == 'vitb_serve_poisson' else ('unchanged_state', 'half_batch'))]


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_fault_makes_run_incorrect(monkeypatch, cell, fault):
    if fault == 'unchanged_state':
        _unchanged_state(monkeypatch)
    elif fault == 'half_batch':
        _half_batch(monkeypatch, cell)
    else:
        _altered_answer(monkeypatch)
    out, _ = toy_run(cell)
    assert out['correct'] is False, out['checks']


def test_command_refuses_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')
    proc = subprocess.run([sys.executable, os.path.join(harness.HERE, 'run.py'), '--workload',
                           CELLS[0], '--seed', '1', '--seconds', '1', '--trace', '0'],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ''


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_short_run_on_card(card, cell):
    proc = subprocess.run([sys.executable, os.path.join(harness.HERE, 'run.py'), '--workload',
                           cell, '--seed', '3', '--seconds', '3', '--trace', '0'],
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])['correct'] is True


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_the_check(cell):
    """The control -- the reference in the program's place, one precision
    below the configuration's (float8 Linear layers) -- reads above at least
    one of the cell's limits, at a toy size on the CPU."""
    import time
    import torch
    from conftest import TINY, TOY_TRAFFIC
    from port_bench import checks, inputs, records
    from port_bench.drivers import mae_stream, serve, train
    r = harness.Run(workload=cell, seed=11, seconds=1.0, trace=False, device=torch.device('cpu'),
                    t_process=time.perf_counter())
    _, r.cell, r.config, r.traffic = harness.resolve(cell)
    r.config.update(TINY)
    r.traffic.update(TOY_TRAFFIC[cell])
    driver = r.traffic['driver']
    if driver == 'serve':
        sched = records.schedule(r.traffic, r.seed, r.traffic['rate_per_s'], 2.0)
        sample = records.check_sample(sched, r.traffic['check_sample'], r.seed)
        base = serve.reference_probs(r, sched, sample, 'f32')
        low = serve.reference_probs(r, sched, sample, 'fp8')
        numbers = {'prob_gap': max(float(np.abs(low[i] - base[i]).max()) for i in sample)}
    elif driver == 'mae_stream':
        paths = inputs.write_shards(r.scratch('shards'), r.traffic['corpora'],
                                    r.config['num_channels'], float(r.traffic['wire_scale']),
                                    r.seed, r.device)
        numbers = checks.gaps(mae_stream.follow(r, paths, 1000, 'fp8'),
                              mae_stream.follow(r, paths, 1000, 'f32'))
    else:
        rows = train.check_rows(r)
        sig, lab = inputs.ptbxl_split(r.traffic['train_records'], r.config['num_channels'],
                                      r.config['record_samples'], r.config['num_class'],
                                      r.seed, r.device)
        sig, lab = sig[torch.as_tensor(rows)], lab[torch.as_tensor(rows)]
        steps = len(rows) // r.traffic['batch_size']
        numbers = checks.gaps(train.follow(r, sig, lab, steps, 1000, 'fp8'),
                              train.follow(r, sig, lab, steps, 1000, 'f32'))
    limits = r.cell['limits']
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)

