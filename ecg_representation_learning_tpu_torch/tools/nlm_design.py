"""Builds of the NLM kernel side by side on the GPU: the design constants of
``ops/csrc/nlm.cu``, and an earlier ``nlm.cu`` if one is given.

    python -m ecg_representation_learning_tpu_torch.tools.nlm_design \\
        [--other NAME=PATH ...] [--out FILE]

Each build in ``BUILDS`` is a copy of the checkout's ``nlm.cu`` with design
constants changed: ``kShifts``, the shifts per barrier of the register
branch; ``kK``, its positions per thread; the accurate ``expf`` against
``__expf``.  ``--other`` adds a source whose ``nlm_rows`` entry has the same
C interface (an earlier commit's ``nlm.cu``, unpacked with ``git archive``).
All are compiled together with the port's nvcc flags into
``build/nlm_design/``, and ptxas' registers and spills are reported for each.
Each build's ``nlm_rows`` is then timed in device ms (calls queued behind a
spin kernel) at ``CASES``, in the order A B ... B A so that drift over the
run shows, and its output is held against ``nlm_rows_reference`` in f32 and
against the same plain version evaluated in f64.  Prints one JSON object per
line, and writes them to ``--out`` as well.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import synth_ecg
from ..ops import _build
from ..ops.nlm_fused import ARGTYPES, nlm_bandwidth, nlm_rows_reference
from ..ops.preprocess import zheng_detrend
from ..runtime import default_device

BUILD_DIR = _build.BUILD_DIR.parent / 'nlm_design'
# name: the design constants of nlm.cu to set ({constant: value}; 'exp': the
# function the weights call); 'base' is nlm.cu as it is
BUILDS: Dict[str, Dict[str, object]] = {
    'base': {},
    'shifts2': {'kShifts': 2},
    'shifts4': {'kShifts': 4},
    'k9': {'kK': 9},
    'k13': {'kK': 13},
    'k15': {'kK': 15},
    'k15_shifts4': {'kK': 15, 'kShifts': 4},
    'fast_exp': {'exp': '__expf'},
}
# (name, rows, L, search, pw): the denoise chain's rows of 64 records at full
# search and search 128 and of 16 records, and chip_smoke.py's generic-branch
# cases (pw 7 with an all-zero row, rows longer than the register branch
# stages and than shared memory holds)
CASES = [('chain_full', 768, 2500, 2500, 10), ('chain_128', 768, 2500, 128, 10),
         ('chain_16_records', 192, 2500, 2500, 10), ('ragged_zero_row', 77, 1999, 64, 7),
         ('long_rows', 24, 9000, 5000, 10), ('longer_than_smem', 2, 70000, 64, 10)]
SCALE = {'ragged_zero_row': 10.0, 'long_rows': 1.0, 'longer_than_smem': 1.0}
SPIN_CYCLES = 100_000_000    # ~50 ms at 1.98 GHz, longer than queueing the calls


def variant_source(base: str, change: Dict[str, object]) -> str:
    """nlm.cu's text with its design constants set as ``change`` says;
    raises if a constant's line is not there exactly once (the source moved
    on: update ``BUILDS``)."""
    for name, value in change.items():
        if name == 'exp':
            pattern, line = r'return EXP \? \w+\(', f'return EXP ? {value}('
        else:
            pattern, line = rf'constexpr int {name} = \d+;', f'constexpr int {name} = {value};'
        base, count = re.subn(pattern, line, base)
        if count != 1:
            raise ValueError(f'{pattern!r} matches {count} times in nlm.cu, not once')
    return base


def ptxas_summary(log: str) -> Dict[str, str]:
    """ptxas' registers and spills of the nlm_rows kernels (all four switches
    on) in a -Xptxas=-v log: {kernel: its ptxas lines}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in ('nlm_res_kernel', 'nlm_gen_kernel', 'nlm_kernel')
                         if k in m.group(1) and 'ILb1ELb1ELb1ELb1E' in m.group(1)), None)
        elif name and ('spill' in line or 'registers' in line):
            out[name] = f"{out.get(name, '')} {line.strip()}".strip()
    return out


def build_all(sources: Dict[str, str]) -> Dict[str, Path]:
    """Compile each {name: source text} into BUILD_DIR, all nvcc started
    together; {name: library}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, text in sources.items():
        src = BUILD_DIR / f'{name}.cu'
        src.write_text(text)
        lib = BUILD_DIR / f'lib{name}.so'
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)]
        jobs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs, failed = {}, []
    for name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log[-4000:]}')
        else:
            libs[name] = lib
            emit({'build': name, 'ptxas': ptxas_summary(log)})
    if failed:
        raise RuntimeError('build failed:\n' + '\n'.join(failed))
    return libs


def run(lib: _build.CtypesLibrary, x: torch.Tensor, hinv: torch.Tensor, sch: int,
        pw: int) -> torch.Tensor:
    """One launch of the library's ``nlm_rows`` (not counted)."""
    out = torch.empty_like(x)
    lib.launch('nlm_rows', None, x.device, (x.data_ptr(), hinv.data_ptr(), out.data_ptr(),
                                            x.shape[0], x.shape[1], sch, pw))
    return out


def device_ms(call, reps: int) -> Optional[float]:
    """Device ms per call of ``call`` queued behind a spin kernel; None if
    queueing outlasted the spin."""
    call()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    ev[2].synchronize()
    if queued_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / reps


def case_inputs(dev: torch.device) -> List[tuple]:
    """(name, x, h, search, pw, zero rows) for each of CASES."""
    x = synth_ecg(np.random.default_rng(8), 64, length=2500, fqs=250)
    y2 = zheng_detrend(torch.from_numpy(x).to(dev), 250).reshape(-1, 2500)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = []
    for name, rows, n, sch, pw in CASES:
        if name.startswith('chain_'):
            xr = y2[:rows].contiguous()
        else:
            xr = SCALE[name] * torch.randn((rows, n), generator=gen, device=dev)
        zero = (5,) if name == 'ragged_zero_row' else ()
        for r in zero:
            xr[r] = 0.0
        out.append((name, xr, nlm_bandwidth(xr, 1.5, pw), sch, pw, zero))
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor, zero) -> float:
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    keep[list(zero)] = False
    return ((got[keep].double() - want[keep].double()).abs().max() / x.abs().max()).item()


LINES: List[str] = []     # what this run printed, for --out


def emit(obj) -> None:
    LINES.append(json.dumps(obj))
    print(LINES[-1], flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--other', action='append', default=[], metavar='NAME=PATH',
                    help='another nlm.cu with the same nlm_rows interface')
    ap.add_argument('--out', type=Path, help='also write the JSON lines here')
    args = ap.parse_args(argv)
    dev = default_device()
    base = (_build.CSRC / 'nlm.cu').read_text()
    sources = {name: variant_source(base, change) for name, change in BUILDS.items()}
    for item in args.other:
        name, path = item.split('=', 1)
        sources[name] = Path(path).read_text()
    t0 = time.perf_counter()
    fns = {name: _build.CtypesLibrary(lib, ARGTYPES) for name, lib in build_all(sources).items()}
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({'env': smi, 'torch': torch.__version__, 'build_s': time.perf_counter() - t0})
    order = list(fns) + list(fns)[::-1]
    for name, x, h, sch, pw, zero in case_inputs(dev):
        hinv = (1.0 / h).contiguous()
        want32 = nlm_rows_reference(x, h, sch, pw)
        want64 = nlm_rows_reference(x.double(), h.double(), sch, pw)
        row = {'case': name, 'shape': list(x.shape), 'sch_wd': sch, 'patch_wd': pw,
               'plain_f32_vs_f64': rel_err(want32, want64, x, zero), 'builds': {}}
        reps = 10 if sch > 1000 else 50
        for b in order:
            got = run(fns[b], x, hinv, sch, pw)
            ms = device_ms(lambda b=b: run(fns[b], x, hinv, sch, pw), reps)
            r = row['builds'].setdefault(b, {'device_ms': []})
            r['device_ms'].append(ms)
            if 'err_vs_plain_f32' not in r:
                r['err_vs_plain_f32'] = rel_err(got, want32, x, zero)
                r['err_vs_plain_f64'] = rel_err(got, want64, x, zero)
                again = run(fns[b], x, hinv, sch, pw)
                r['same_bits_twice'] = bool(torch.equal(got.view(torch.int32),
                                                        again.view(torch.int32)))
        emit(row)
        del want32, want64
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text('\n'.join(LINES) + '\n')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
