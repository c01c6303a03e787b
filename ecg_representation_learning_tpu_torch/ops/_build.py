"""Build the port's CUDA kernels with nvcc, and its host C++ libraries with
the host compiler, and load them with ctypes.

Each source ``ops/csrc/<name>.cu`` exposes a plain C interface and compiles,
at first use, into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of
the checkout, for ``sm_90a`` (Hopper).  The hash covers the source, every
header ``csrc/*.cuh`` (the sources include them) and the flags, so an edited
kernel or header is rebuilt and a stale library is never loaded.
ptxas's register and shared-memory report for each kernel is kept beside
the library as ``<library>.log``.  Nothing here runs when the module is
imported: the CPU tests import every module, and there is no nvcc there.

``build_host`` does the same for a C++ source of the host data plane
(``data/csrc/wfdb_native.cpp``) with ``g++`` (or ``$CXX``) and the flags
``CXX_FLAGS``; its hash also covers the compiler and the CPU that
``-march=native`` resolves to, so a library built on another machine is
never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
# --split-compile=0 optimizes a source's kernels in parallel on every core
# (flash_bwd.cu has 32 kernel instantiations)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v', '--split-compile=0')

# the JAX package's native/Makefile flags
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-shared', '-std=c++17', '-pthread')

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
    digest = hashlib.sha1((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
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


def host_compiler() -> Optional[str]:
    """The C++ compiler (``$CXX``, else ``g++``) on PATH, or None."""
    return shutil.which(os.environ.get('CXX') or 'g++')


def _host_target(cxx: str) -> bytes:
    """What ``-march=native`` means on the host, as the compiler says."""
    res = subprocess.run([cxx, '-march=native', '-Q', '--help=target'], capture_output=True)
    return res.stdout + res.stderr


def host_library_path(source: Path, cxx: str) -> Path:
    """Where the library built from the C++ ``source`` with ``cxx`` lives."""
    digest = hashlib.sha1(source.read_bytes())
    digest.update(' '.join((cxx, *CXX_FLAGS)).encode())
    digest.update(_host_target(cxx))
    return BUILD_DIR / f'lib{source.stem}-{digest.hexdigest()[:12]}.so'


def build_host(source: Path) -> Optional[Path]:
    """The library built from the C++ ``source`` (compiled now unless it is
    built already), or None when there is no host compiler.  Raises with the
    compiler's output if the compile fails."""
    cxx = host_compiler()
    if cxx is None:
        return None
    out = host_library_path(source, cxx)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    res = subprocess.run([cxx, *CXX_FLAGS, '-o', str(tmp), str(source)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'host build of {source.name} failed: {cxx} exited '
                           f'{res.returncode}\n{res.stdout}')
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out
