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

``CtypesLibrary`` is the one binding of a kernel library's entries: it
launches an entry on the current stream of a card, raises on a CUDA error
and counts the launch in the registry of launch counters, one per kernel
(``COUNTERS``), which ``launch_counts``, ``add_launches`` and
``reset_launches`` read and move.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Sequence, Union

import torch

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


# the launch counter of each hand-written kernel, by its name in
# chip_smoke.py's kernels line (``_bwd``: the entry's backward); #1 and #2
# share the entry flash_fwd.  ``flash_bwd_ws`` counts the launches of #3 or
# #4 that took the warp-specialised kernels, as the C side reports each call
# (aligned bf16 arrays).  ``param_cast`` counts the casts of a parameter to
# its layer's compute dtype that a training forward on the card still makes
# (``train/loop.count_param_casts``): 0 where kernel #5's compute copies are
# read
COUNTERS = ('flash_fwd', 'flash_fwd_lse', 'flash_bwd_dq', 'flash_bwd_dkv', 'flash_bwd_ws',
            'adamw', 'adamw_norm', 'nlm_rows', 'nlm_variant', 'gelu_dropout', 'gelu_dropout_bwd',
            'dropout_add', 'dropout_add_bwd', 'moe_permute', 'moe_permute_bwd', 'moe_swiglu',
            'moe_swiglu_bwd', 'moe_combine', 'moe_combine_bwd', 'param_cast')
_launches: Dict[str, int] = dict.fromkeys(COUNTERS, 0)


def launch_counts() -> Dict[str, int]:
    """Every counter's launches so far (a copy)."""
    return dict(_launches)


def add_launches(delta: Mapping[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters it names (a CUDA graph's
    replays add the launches its capture recorded)."""
    for name, n in delta.items():
        _launches[name] += times * n


def reset_launches() -> None:
    """Set every counter to 0."""
    for name in _launches:
        _launches[name] = 0


class CtypesLibrary:
    """The named C entries of one kernel library: ``csrc/<lib>.cu`` built at
    first use, or a library file at the path ``lib``.  ``argtypes`` holds
    each entry's ctypes arguments by its name; every entry returns an int.
    A launch entry takes the stream last and returns a CUDA error code; a
    launch costs the host a few microseconds besides the ctypes call, so the
    stream is read raw and the device switched only when it is not the
    current one.  The caller checks the arguments."""

    def __init__(self, lib: Union[str, Path], argtypes: Mapping[str, Sequence]):
        self.lib, self._argtypes = lib, argtypes
        self._fns = {}

    def _fn(self, entry: str):
        fn = self._fns.get(entry)
        if fn is None:
            handle = load(self.lib) if isinstance(self.lib, str) else ctypes.CDLL(str(self.lib))
            fn = getattr(handle, entry)
            fn.argtypes, fn.restype = list(self._argtypes[entry]), ctypes.c_int
            self._fns[entry] = fn
        return fn

    def value(self, entry: str, *args) -> int:
        """What an entry that launches nothing returns."""
        return self._fn(entry)(*args)

    def launch(self, entry: str, counter: Optional[str], device: torch.device,
               args: Sequence) -> None:
        """One launch of ``entry`` on ``device``'s current stream, counted
        under ``counter`` (None: not counted); ``args`` are its arguments
        before the stream."""
        fn, dev = self._fn(entry), device.index
        if dev == torch.cuda.current_device():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        if err != 0:
            raise RuntimeError(f'{entry} launch failed: CUDA error {err}')
        if counter is not None:
            _launches[counter] += 1


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
