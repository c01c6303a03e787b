"""The port loads with JAX and the JAX package blocked, and without h5py,
pandas, matplotlib, seaborn and scikit-learn (the GPU machine has none of
them): every module, the ingest and stream modules (``data.readers``,
``data.native``, ``data.export``, ``data.pipeline``, ``cli``) and the tools
(``models.export_artifact``, ``models.tokenizer``, ``utils.viz``,
``utils.rollout``, ``utils.auc_plot``, ``utils.ecg_domain``,
``registry_gen``, ``tools.dryrun_multichip``) and the mesh layer
(``parallel``, ``parallel.distributed``, ``parallel.mesh``,
``parallel.spmd``), ring context parallelism and the GPipe pipeline
(``parallel.ring_attention``, ``parallel.pipeline_parallel``,
``train.long_record``, ``train.pipeline_vit``) among them.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``flax``, ``optax``, ``orbax``, ``h5py``, ``pandas``, ``matplotlib``,
``seaborn``, ``sklearn`` and ``ecg_representation_learning_tpu`` (the name itself or
``ecg_representation_learning_tpu.``-prefixed, so the port
``ecg_representation_learning_tpu_torch`` is not caught), then imports every
module of the port and ``chip_smoke.py``.
"""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import ecg_representation_learning_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]

BLOCKER = '''
import importlib, importlib.abc, importlib.util, sys
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'h5py', 'pandas',
           'matplotlib', 'seaborn', 'sklearn', 'ecg_representation_learning_tpu')

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ImportError(f'blocked import: {name}')
        return None

sys.meta_path.insert(0, Blocker())
for mod in MODULES:
    importlib.import_module(mod)
spec = importlib.util.spec_from_file_location('chip_smoke', CHIP_SMOKE)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + '.') for b in BLOCKED))
assert not leaked, leaked
print('ok', len(MODULES))
'''


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):
        names.append(info.name)
    return names


def _run(code: str):
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_port_and_chip_smoke_import_without_jax():
    modules = _port_modules()
    assert len(modules) >= 14, modules
    pretraining = {f'{port.__name__}.{m}' for m in (
        'models.mae', 'models.contrastive', 'train.pretrain', 'train.contrastive',
        'ops.normalize')}
    assert pretraining <= set(modules), pretraining - set(modules)
    corpus = {f'{port.__name__}.{m}' for m in ('models.quantize', 'models.port',
                                                 'data.datasets', 'train.evaluate', 'cli')}
    assert corpus <= set(modules), corpus - set(modules)
    ingest = {f'{port.__name__}.{m}' for m in (
        'data.readers', 'data.native', 'data.export', 'data.pipeline', 'data.torch_adapter',
        'utils.misc', 'cli')}
    assert ingest <= set(modules), ingest - set(modules)
    tools = {f'{port.__name__}.{m}' for m in (
        'models.export_artifact', 'models.tokenizer', 'utils.viz', 'utils.rollout',
        'utils.auc_plot', 'utils.ecg_domain', 'registry_gen', 'cli')}
    assert tools <= set(modules), tools - set(modules)
    parallel = {f'{port.__name__}.{m}' for m in (
        'parallel', 'parallel.distributed', 'parallel.mesh', 'parallel.spmd',
        'tools.dryrun_multichip')}
    assert parallel <= set(modules), parallel - set(modules)
    ring_pipeline = {f'{port.__name__}.{m}' for m in (
        'parallel.ring_attention', 'parallel.pipeline_parallel', 'train.long_record',
        'train.pipeline_vit')}
    assert ring_pipeline <= set(modules), ring_pipeline - set(modules)
    code = (f'MODULES = {modules!r}\nCHIP_SMOKE = {str(ROOT / "chip_smoke.py")!r}\n'
            + BLOCKER)
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f'ok {len(modules)}'


@pytest.mark.parametrize('name', ['jax', 'ecg_representation_learning_tpu',
                                  'ecg_representation_learning_tpu.registry', 'h5py',
                                  'pandas', 'matplotlib', 'seaborn', 'sklearn'])
def test_blocker_blocks_the_jax_side(name):
    code = f'MODULES = [{name!r}]\nCHIP_SMOKE = ""\n' + BLOCKER
    res = _run(code)
    assert res.returncode != 0
    # a submodule fails at its parent package, which is imported first
    assert f'blocked import: {name.split(".")[0]}' in res.stderr
