"""The port's tracing (``utils/tracing.py``) on the CPU: spans and the
training step's phase marks, on while a ``torch.profiler`` session
records and free of profiler ranges while off; the marks of a ``Dispatcher``
and of the per-step loop credited per step; and no number of a step moved by
tracing it."""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits, synth_ptbxl
from ecg_representation_learning_tpu_torch.train import Trainer
from ecg_representation_learning_tpu_torch.train.dispatch import Dispatcher
from ecg_representation_learning_tpu_torch.utils import misc, tracing

torch.set_num_threads(2)
PHASES = ('forward', 'backward', 'update', 'tail')
BSZ = 8


@pytest.fixture(scope='module')
def splits():
    signals, labels, folds = synth_ptbxl(n=96, length=640)
    return get_ptbxl_splits(signals, labels, folds)


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


def _trainer(splits, tmp_path, accum=1, **kw) -> Trainer:
    cfg = VitConfig.from_defined('debug', max_signal_length=704, num_hidden_layers=2,
                                 flash_min_seq=0)
    tcfg = TrainConfig(num_train_epoch=1, train_batch_size=BSZ, eval_batch_size=BSZ,
                       learning_rate=1e-3, log_to_console=False, save_final=False,
                       do_eval=False, grad_accum=accum, seed=3, **kw)
    tr = Trainer(cfg, tcfg, train_data=splits.train, output_dir=str(tmp_path), device='cpu')
    tr.init_state()
    return tr


def _takes(k: int, first: int = 0) -> np.ndarray:
    return np.arange(first * BSZ, (first + k) * BSZ).reshape(k, BSZ)


def _host_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def test_off_opens_no_range_and_records_nothing(splits, tmp_path, monkeypatch):
    opened = []
    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', lambda *a: opened.append(a))
    monkeypatch.setattr(torch.profiler, 'record_function', lambda *a: opened.append(a))
    assert not tracing.enabled()
    assert tracing.span('dispatch', 3) is tracing.span('step.forward')
    with tracing.span('dispatch', 3):
        pass
    tr = _trainer(splits, tmp_path)
    disp = Dispatcher(tr, 2, scan=False)
    disp.run(_takes(2))
    tr.train_step(tr.train_data, _takes(1, 2)[0])
    assert opened == []
    assert tracing.snapshot() == {'spans': {}, 'phases': {}, 'gaps': {'count': 0, 'device_s': 0.0}}


def test_spans_nest_under_dispatch_with_the_step(splits, tmp_path):
    tr = _trainer(splits, tmp_path)
    disp = Dispatcher(tr, 2, scan=False)
    disp.run(_takes(2))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        assert tracing.enabled()
        disp.run(_takes(2, 2))
    assert not tracing.enabled()
    ev = {}
    for e in _host_events(prof):
        if e.name().startswith(('dispatch', 'step.')):
            ev.setdefault(e.name(), []).append(e)
    (outer,), (prep,), (launch,) = ev['dispatch'], ev['dispatch.prepare'], ev['dispatch.launch']
    assert outer.concrete_inputs() == prep.concrete_inputs() == launch.concrete_inputs() == [2]
    for child in (prep, launch):
        assert outer.start_ns() <= child.start_ns() <= child.end_ns() <= outer.end_ns()
    assert prep.end_ns() <= launch.start_ns()
    for name in ('step.forward', 'step.backward', 'step.update'):
        assert len(ev[name]) == 2
        assert all(launch.start_ns() <= e.start_ns() <= e.end_ns() <= launch.end_ns()
                   for e in ev[name])
    snap = tracing.snapshot()
    assert {n: s['count'] for n, s in snap['spans'].items()} == {
        'dispatch': 1, 'dispatch.prepare': 1, 'dispatch.launch': 1,
        'step.forward': 2, 'step.backward': 2, 'step.update': 2}
    assert snap['spans']['dispatch']['host_s'] >= (snap['spans']['dispatch.prepare']['host_s']
                                                   + snap['spans']['dispatch.launch']['host_s'])


def test_device_trace_shows_the_dispatch_step(splits, tmp_path):
    import json
    tr = _trainer(splits, tmp_path)
    disp = Dispatcher(tr, 2, scan=False)
    disp.run(_takes(2))
    with tracing.device_trace(str(tmp_path / 'trace')) as path:
        disp.run(_takes(2, 2))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    args = {e['name']: e['args'] for e in events if e.get('name', '').startswith('dispatch')}
    assert set(args) == {'dispatch', 'dispatch.prepare', 'dispatch.launch'}
    assert all(a['Concrete Inputs'] == ['2'] for a in args.values())


@pytest.mark.parametrize('accum', [1, 2])
def test_dispatcher_credits_each_step_its_phases(splits, tmp_path, accum):
    tr = _trainer(splits, tmp_path, accum)
    disp = Dispatcher(tr, 2, scan=False)
    disp.run(_takes(2))          # before the session: not credited
    with profile(activities=[ProfilerActivity.CPU]):
        for i in (1, 2):
            disp.run(_takes(2, 2 * i))
    snap = tracing.snapshot()
    assert set(snap['phases']) == set(PHASES)
    assert all(snap['phases'][p]['steps'] == 4 for p in PHASES)
    assert all(snap['phases'][p]['device_s'] > 0 for p in PHASES)
    total = sum(snap['phases'][p]['device_s'] for p in PHASES)
    assert total <= snap['spans']['dispatch']['host_s']
    assert snap['spans']['dispatch']['count'] == 2
    assert snap['spans']['step.forward']['count'] == 4 * accum
    assert snap['gaps'] == {'count': 0, 'device_s': 0.0}   # no gap off the card


def test_per_step_loop_marks_and_train_reads(splits, tmp_path):
    tr = _trainer(splits, tmp_path)
    tr.train_step(tr.train_data, _takes(1)[0])     # before the session: not credited
    with profile(activities=[ProfilerActivity.CPU]):
        for i in (1, 2, 3):
            tr.train_step(tr.train_data, _takes(1, i)[0])
    tr.train_step(tr.train_data, _takes(1, 4)[0])  # after it: not credited
    snap = tracing.snapshot()
    assert all(snap['phases'][p]['steps'] == 3 for p in PHASES)
    assert 'dispatch' not in snap['spans']
    tracing.reset()
    tr = _trainer(splits, tmp_path, steps_per_dispatch=2)
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train()
    snap = tracing.snapshot()
    steps = tr.steps_per_epoch
    assert snap['spans']['train.read']['count'] == steps // 2 + steps % 2
    assert snap['spans']['dispatch']['count'] == steps // 2
    assert all(snap['phases'][p]['steps'] == steps for p in PHASES)


def test_tracing_changes_no_number(splits, tmp_path):
    def run(traced: bool):
        tr = _trainer(splits, tmp_path)
        disp = Dispatcher(tr, 2, scan=False)
        with profile(activities=[ProfilerActivity.CPU]) if traced else tracing._OFF:
            losses, gnorms, _ = disp.run(_takes(2))
            last = tr.train_step(tr.train_data, _takes(1, 2)[0])
        return (torch.cat([losses, last['loss'].reshape(1)]),
                torch.cat([gnorms, last['grad_norm'].reshape(1)]),
                {k: v.detach().clone() for k, v in tr.model.state_dict().items()})

    off, on = run(False), run(True)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert all(torch.equal(off[2][k], on[2][k]) for k in off[2])
    assert tracing.snapshot()['phases']['forward']['steps'] == 3


def test_step_timer_and_device_trace_keep_their_import_paths():
    from ecg_representation_learning_tpu_torch import utils
    assert misc.StepTimer is utils.StepTimer is tracing.StepTimer
    assert misc.device_trace is utils.device_trace is tracing.device_trace
