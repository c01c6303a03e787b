"""The run of one cell: resolve it by name to its files, drive it, judge it,
and print the result line.

A cell (``cells/<name>.json``) names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names the driver
(``drivers/<driver>.py``) that runs it, and the cell holds the limits of the
numbers its check compares.  ``BENCHMARK.json`` says which end-to-end
metrics a cell reports and which per-layer metrics (``metrics/<name>.py``,
each a ``read(run)`` that returns a number or None) a traced run reads.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules a run may not hold once its window has closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ecg_representation_learning_tpu')


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


@dataclasses.dataclass
class Run:
    """One run of one cell, filled in by its driver."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float                      # perf_counter at process start
    cell: dict = dataclasses.field(default_factory=dict)
    config: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    window: Dict[str, float] = dataclasses.field(default_factory=dict)
    serve: Dict[str, float] = dataclasses.field(default_factory=dict)
    tr: Any = None                        # the traced slice (trace.Trace)
    checks: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    chips: int = 1
    overrides: Dict[str, dict] = dataclasses.field(default_factory=dict)   # tests: toy sizes

    def start_window(self) -> float:
        """Mark the first timed unit of work: set-up ends here."""
        now = time.perf_counter()
        self.e2e['setup_s'] = now - self.t_process
        return now

    def scratch(self, *parts: str) -> str:
        """A directory of this run under the temporary directory."""
        import tempfile
        path = os.path.join(tempfile.gettempdir(), 'port_bench', self.workload, *parts)
        os.makedirs(path, exist_ok=True)
        return path


def cells() -> List[str]:
    """Every cell the harness has a file for (``BENCHMARK.json`` names the
    ones a check runs)."""
    return sorted(f[:-len('.json')] for f in os.listdir(os.path.join(HERE, 'cells'))
                  if f.endswith('.json'))


def resolve(workload: str) -> Tuple[dict, dict, dict, dict]:
    """(the BENCHMARK.json entry, or {'chips': 1} for a cell it does not
    name; the cell; its configuration; its traffic)."""
    if workload not in cells():
        raise SystemExit(f'unknown workload {workload!r}')
    entry = next((w for w in benchmark()['workloads'] if w['name'] == workload),
                 {'chips': 1})
    cell = load_json('cells', f'{workload}.json')
    config = load_json('configs', f'{cell["config"]}.json')
    traffic = load_json('traffic', f'{cell["traffic"]}.json')
    return entry, cell, config, traffic


def metric_lists(workload: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and the per-layer metrics that ``workload`` reports."""
    bench = benchmark()
    e2e = [m for m in bench['end_to_end'] if workload in m.get('workloads', [workload])]
    names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if (workload in m['workloads'] if 'workloads' in m else m['moves'] in names)]
    return e2e, layer


def read_metric(name: str, run: Run) -> Optional[float]:
    path = os.path.join(HERE, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'port_bench_metric_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)


def execute(run: Run) -> dict:
    """Drive ``run`` and return its result line (a dict)."""
    entry, run.cell, run.config, run.traffic = resolve(run.workload)
    run.config = {**run.config, **run.overrides.get('config', {})}
    run.traffic = {**run.traffic, **run.overrides.get('traffic', {})}
    run.chips = entry['chips']
    driver = importlib.import_module(f'port_bench.drivers.{run.traffic["driver"]}')
    driver.run(run)
    e2e, layer = metric_lists(run.workload)
    if run.trace:
        metrics = {}
        for m in layer:
            v = read_metric(m['name'], run)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': run.e2e[m['name']], 'unit': m['unit']} for m in e2e}
    device = {'platform': 'gpu' if str(run.device).startswith('cuda') else 'cpu',
              'kind': _device_kind(run.device), 'count': run.chips,
              'memory_peak_bytes': run.memory_peak}
    out = {'correct': all(v <= lim for _, v, lim in run.checks) and bool(run.checks),
           'attempted': run.attempted, 'failed': run.failed, 'metrics': metrics,
           'device': device}
    if run.trace and run.tr is not None and run.tr.busy_s is not None:
        device['busy_s'], device['window_s'] = run.tr.busy_s, run.tr.window_s
        out['breakdown'] = run.tr.breakdown
    out['checks'] = {n: {'value': v, 'limit': lim} for n, v, lim in run.checks}
    return out


def _device_kind(device) -> str:
    import torch
    if torch.device(device).type == 'cuda':
        return torch.cuda.get_device_name(device)
    return 'cpu'
