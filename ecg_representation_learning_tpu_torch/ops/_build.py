"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``ops/csrc/<name>.cu`` exposes a plain C interface and compiles,
at first use, into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of
the checkout, for ``sm_90a`` (Hopper).  The hash covers the source and the
flags, so an edited kernel is rebuilt and a stale library is never loaded.
ptxas's register and shared-memory report for each kernel is kept beside
the library as ``<library>.log``.  Nothing here runs when the module is
imported: the CPU tests import every module, and there is no nvcc there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH')):
        if root and (Path(root) / 'bin' / 'nvcc').is_file():
            return str(Path(root) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')   # the toolkit's default prefix
    if default.is_file():
        return str(default)
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha1(src.read_bytes() + ' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:12]}.so'


def build(names: Iterable[str]) -> None:
    """Compile every library in ``names`` that is not built yet, one nvcc
    per source, all started together.  Raises with nvcc's output if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        Path(f'{out}.log').write_text(log)
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``'s library, built at first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
