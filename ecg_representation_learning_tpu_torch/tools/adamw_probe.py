"""Kernel #5 (``ops/csrc/adamw.cu``) and the FusedAdamW tail on the GPU, in
numbers that can be set beside another checkout's.

    python -m ecg_representation_learning_tpu_torch.tools.adamw_probe \\
        [--label NAME] [--designs] [--out FILE]

To measure another checkout's port with the same code, copy this file into
that checkout's ``tools/`` and run it there: it calls only
``ops.adamw.adamw_update`` (the update alone, scalars given), the
``adamw_kernel`` binding, ``Trainer`` and ``train.trainer.finish_update``,
which every version of the port has, and the fused tail where there is one.

- ``update`` lines, for every ViT-base leaf (85.7 M parameters) and for the
  Switch-MoE ViT-base tree (4 experts on every second block, 170.7 M), with
  f32 and bf16 mu: the update's device ms (calls queued behind a spin
  kernel), its ms per call back to back, and the wrapper's host us per call
  (calls queued behind a long spin, timed on the host clock, so the device
  is out of the way); the same three for ``torch.optim.AdamW(fused=True)``
  on the same tensors (f32 moments: it has no bf16 one); the bound (bytes
  over 3.35 TB/s).  Where the checkout has the fused tail, also the norm
  launch's device ms against its bound (g read once), and the tail's (both
  launches and the copy).  Then a ``copy`` line: ``Tensor.copy_`` moving the
  update's 2.4 GB, the rate the card streams at in practice.
- a ``train`` line: ViT-base bf16 ``Trainer.train()`` for 2 epochs on the
  hard synthetic corpus (as chip_smoke.py's training phase): block-table
  rebuilds over the run, the device launches and copies of one step's
  update tail (a profile of one ``finish_update`` call alone), and train
  samples/s over 10 steps.
- with ``--designs``: copies of adamw.cu with other ``kThreads`` /
  ``kUnroll`` / ``kNormRows`` (``DESIGNS``), built together into
  ``build/adamw_design/``, their ptxas registers, and each one's update and
  norm device ms at ViT-base f32 mu in the order A B ... B A, the update
  checked bit for bit against the plain version and the norm against
  ``global_norm``.

Prints one JSON object per line, and writes them to ``--out`` as well.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs import TrainConfig, VitConfig
from ..models.vit import EcgVit
from ..ops import _build, adamw

HBM_BYTES_PER_S = 3.35e12
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
MOE = dict(moe_num_experts=4, moe_every=2, moe_capacity_factor=1.25)
SPIN_CYCLES = 400_000_000    # ~0.2 s at 1.98 GHz: longer than queueing 30 calls of any version
REPS = 30
# name: design constants of adamw.cu; 'base' is the checkout's source
DESIGNS: Dict[str, Dict[str, int]] = {
    'base': {},
    'unroll2': {'kUnroll': 2},
    'threads512_unroll2': {'kThreads': 512, 'kUnroll': 2},
    'norm_rows1': {'kNormRows': 1},
    'norm_rows2': {'kNormRows': 2},
    'norm_rows8': {'kNormRows': 8},
}
DESIGN_DIR = _build.BUILD_DIR.parent / 'adamw_design'


def emit(obj, out: Optional[List[dict]] = None) -> None:
    print(json.dumps(obj), flush=True)
    if out is not None:
        out.append(obj)


def tree_shapes(moe: bool) -> List[torch.Size]:
    """Every parameter shape of ViT-base (with ``MOE`` experts when ``moe``)."""
    cfg = VitConfig.from_defined('base', **(MOE if moe else {}))
    with torch.device('meta'):
        return [p.shape for p in EcgVit(cfg).parameters()]


def make_leaves(shapes, mu_dtype: torch.dtype, seed: int = 0) -> Dict[str, list]:
    """params, grads, mus, nus for ``shapes`` on the card, from a seed."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    rand = lambda s: torch.randn(s, generator=gen, device='cuda')
    return {'params': [rand(s) for s in shapes], 'grads': [rand(s) for s in shapes],
            'mus': [(0.1 * rand(s)).to(mu_dtype) for s in shapes],
            'nus': [torch.rand(s, generator=gen, device='cuda') * 0.01 for s in shapes]}


def scalars_for(count: int = 1, scale: float = 1.0, finite: float = 1.0) -> torch.Tensor:
    return torch.tensor([scale, 3e-4, 1 - 0.9 ** count, 1 - 0.999 ** count, finite],
                        dtype=torch.float32, device='cuda')


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """ms per call of ``fn`` back to back (CUDA events): host and device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _behind_spin(fn, reps: int):
    """Queue ``reps`` calls behind a spin kernel: (device ms per call, host
    us per call), the device time None if queueing outlasted the spin."""
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    events[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    events[2].record()
    events[2].synchronize()
    if 1e3 * host_s >= events[0].elapsed_time(events[1]):
        return None, 1e6 * host_s / reps
    return events[1].elapsed_time(events[2]) / reps, 1e6 * host_s / reps


def device_and_host(fn, reps: int = REPS, warmup: int = 3):
    """(device ms per call, host us per call) with the calls queued behind a
    spin kernel: the device runs them back to back and the host clock sees
    only the host's work."""
    for _ in range(warmup):
        fn()
    return _behind_spin(fn, reps)


def update_bytes(n: int, mu_dtype: torch.dtype) -> int:
    """g, mu, nu, p read once and mu, nu, p written once."""
    mu = torch.finfo(mu_dtype).bits // 8
    return n * (5 * 4 + 2 * mu)


def update_row(name: str, shapes, mu_dtype: torch.dtype) -> dict:
    """Kernel #5's update and the library's step on one tree."""
    t = make_leaves(shapes, mu_dtype)
    n = sum(s.numel() for s in shapes)
    scalars = scalars_for()
    call = lambda: adamw.adamw_update(t['params'], t['grads'], t['mus'], t['nus'], scalars,
                                      **HYPER)
    row = {'what': 'update', 'tree': name, 'leaves': len(shapes), 'params': n,
           'mu_dtype': str(mu_dtype),
           'bound_ms': update_bytes(n, mu_dtype) / HBM_BYTES_PER_S * 1e3}
    row['kernel_device_ms'], row['host_us_per_call'] = device_and_host(call)
    row['kernel_ms'] = time_ms(call)
    builds = getattr(adamw.adamw_kernel, 'table_builds', None)
    if builds is not None:
        row['table_builds_so_far'] = builds
    if row['kernel_device_ms']:
        row['bound_share'] = row['bound_ms'] / row['kernel_device_ms']
    if hasattr(adamw, 'adamw_tail'):   # the fused tail: the norm launch and both together
        kern = adamw.adamw_kernel
        g_bytes = 4 * n
        norm = lambda: kern.norm_scalars(t['params'], t['grads'], t['mus'], t['nus'],
                                         (3e-4, 0.1, 0.001), clip_norm=1.0,
                                         zero_nonfinite=True)
        tail = lambda: adamw.adamw_tail(t['params'], t['grads'], t['mus'], t['nus'],
                                        (3e-4, 0.1, 0.001), clip_norm=1.0,
                                        zero_nonfinite=True, **HYPER)
        row['norm_bound_ms'] = g_bytes / HBM_BYTES_PER_S * 1e3
        row['norm_device_ms'], row['norm_host_us_per_call'] = device_and_host(norm)
        row['tail_device_ms'], row['tail_host_us_per_call'] = device_and_host(tail)
        row['tail_ms'] = time_ms(tail)
    del t
    torch.cuda.empty_cache()
    if mu_dtype == torch.float32:
        t = make_leaves(shapes, mu_dtype)
        lib = [torch.nn.Parameter(p) for p in t['params']]
        for p, g in zip(lib, t['grads']):
            p.grad = g
        opt = torch.optim.AdamW(lib, lr=3e-4, weight_decay=1e-2, fused=True)
        row['library_device_ms'], row['library_host_us_per_call'] = device_and_host(opt.step)
        row['library_ms'] = time_ms(opt.step)
        del lib, opt, t
        torch.cuda.empty_cache()
    return row


def copy_row(n_bytes: int) -> dict:
    """The card's streaming rate for the update's traffic: ``copy_`` of
    n_bytes / 2 into another buffer (n_bytes moved), in device ms and TB/s."""
    src = torch.ones(n_bytes // 8, device='cuda')
    dst = torch.empty_like(src)
    ms = device_and_host(lambda: dst.copy_(src))[0]
    return {'what': 'copy', 'bytes_moved': 8 * src.numel(), 'device_ms': ms,
            'tb_per_s': 8 * src.numel() / ms / 1e9 if ms else None,
            'share_of_3.35': 8 * src.numel() / ms / 1e9 / 3.35 if ms else None}


def _count_table_builds(kern) -> Callable[[], int]:
    """A reader of the block- or leaf-table rebuilds since now, whether the
    binding counts them (``table_builds``) or not (an older ``_table_for``,
    wrapped here to count the calls that changed its key)."""
    if hasattr(kern, 'table_builds'):
        start = kern.table_builds
        return lambda: kern.table_builds - start
    count = [0]
    orig = kern._table_for

    def counting(*args):
        old = kern._key
        orig(*args)
        count[0] += kern._key is not old
    kern._table_for = counting
    return lambda: count[0]


def tail_profile(tr, data, take: np.ndarray) -> dict:
    """The device launches and copies of one step's update tail: a profile
    of one ``finish_update`` call alone, the device idle before and after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..train import trainer as trainer_mod
    orig = trainer_mod.finish_update
    seen: Dict[str, object] = {}

    def profiled(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            t0 = time.perf_counter()
            res = orig(*args, **kw)
            seen['host_ms'] = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            time.sleep(0.02)
        seen['events'] = [(e.key, e.count, e.self_device_time_total)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and e.count > 0]
        return res
    trainer_mod.finish_update = profiled
    try:
        float(tr.train_step(data, take)['loss'])
    finally:
        trainer_mod.finish_update = orig
    events = seen['events']
    copies = [e for e in events if e[0].startswith(('Memcpy', 'Memset'))]
    kernels = [e for e in events if not e[0].startswith(('Memcpy', 'Memset'))]
    return {'tail_kernel_launches': sum(c for _, c, _ in kernels),
            'tail_copies': sum(c for _, c, _ in copies),
            'tail_device_ms': sum(t for _, _, t in events) / 1e3,
            'tail_host_ms': seen['host_ms'],
            'tail_events': [{'name': k[:80], 'count': c, 'device_us': t} for k, c, t in events]}


def train_row() -> dict:
    """ViT-base bf16 ``Trainer.train()`` (chip_smoke.py's training run):
    table rebuilds, the tail's launches per step, samples/s."""
    from ..data import get_ptbxl_splits, synth_ptbxl
    from ..ops import attention
    from ..registry import PTBXL_TRAIN_STATS
    from ..train import Trainer
    attention.BLOCKED_BWD_MIN_SEQ = 0   # every layer on kernels #2-#4, as chip_smoke.py
    signals, labels, folds = synth_ptbxl(n=832, hard=True, n_marker_classes=16)
    splits = get_ptbxl_splits(signals, labels, folds)
    cfg = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    tr = Trainer(cfg, TrainConfig(num_train_epoch=2, train_batch_size=64, augment_timeout=True,
                                  log_to_console=False, save_final=False),
                 train_data=splits.train, eval_data=splits.eval,
                 norm_stats=PTBXL_TRAIN_STATS['original'], output_dir='runs/adamw_probe')
    builds = _count_table_builds(adamw.adamw_kernel)
    t0 = time.perf_counter()
    tr.train()
    row = {'what': 'train', 'model': 'ecg-vit-base', 'dtype': 'bfloat16', 'steps': tr.step,
           'train_seconds': time.perf_counter() - t0, 'table_builds': builds()}
    take = np.arange(64)
    row.update(tail_profile(tr, splits.train, take))
    float(tr.train_step(splits.train, take)['loss'])
    t0 = time.perf_counter()
    for i in range(10):
        m = tr.train_step(splits.train, np.arange(i * 64, (i + 1) * 64) % len(splits.train))
    float(m['loss'])
    row['train_samples_per_s_bf16'] = 640 / (time.perf_counter() - t0)
    row['table_builds_after_steps'] = builds()
    return row


def design_source(base: str, change: Dict[str, int]) -> str:
    for const, value in change.items():
        base, n = re.subn(rf'constexpr int {const} = \d+;', f'constexpr int {const} = {value};',
                          base)
        if n != 1:
            raise ValueError(f'adamw.cu has no single constexpr {const}')
    return base


def build_designs() -> Dict[str, Path]:
    """Compile each design into DESIGN_DIR, all nvcc at once."""
    DESIGN_DIR.mkdir(parents=True, exist_ok=True)
    base = (_build.CSRC / 'adamw.cu').read_text()
    jobs = []
    for name, change in DESIGNS.items():
        src = DESIGN_DIR / f'{name}.cu'
        src.write_text(design_source(base, change))
        lib = DESIGN_DIR / f'lib{name}.so'
        jobs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc exited {proc.returncode}\n{log[-4000:]}')
        (DESIGN_DIR / f'{name}.log').write_text(log)
        libs[name] = lib
    return libs


def design_rows(out: List[dict]) -> None:
    """Each design's update and norm launch at ViT-base f32 mu, A B ... B A;
    the update bit for bit against the plain version, the norm against
    ``global_norm``."""
    libs = build_designs()
    shapes = tree_shapes(moe=False)
    t = make_leaves(shapes, torch.float32)
    ptrs = np.array([(p.data_ptr(), m.data_ptr(), v.data_ptr())
                     for p, m, v in zip(t['params'], t['mus'], t['nus'])])
    gptrs = torch.tensor([g.data_ptr() for g in t['grads']], dtype=torch.int64, device='cuda')
    sizes = [s.numel() for s in shapes]
    scalars = scalars_for()
    ws = torch.zeros(8, device='cuda')
    plain_norm = adamw.global_norm(t['grads']).item()
    dev = ws.device
    b1, b2 = HYPER['b1'], HYPER['b2']
    calls = {}
    for name, path in libs.items():
        lib = _build.CtypesLibrary(path, adamw.ARGTYPES)
        rows = adamw.block_table(ptrs, sizes, 4, lib.value('adamw_chunk_elems'))
        blocks = torch.from_numpy(rows).cuda()
        parts = torch.empty(-(-len(rows) // lib.value('adamw_norm_rows')), dtype=torch.float64,
                            device='cuda')
        ticket = torch.zeros(1, dtype=torch.int32, device='cuda')
        update = (lambda lib=lib, blocks=blocks, n=len(rows): lib.launch(
            'adamw_update', None, dev, (blocks.data_ptr(), gptrs.data_ptr(), 1, n,
                                        scalars.data_ptr(), 0, b1, 1.0 - b1, b2, 1.0 - b2,
                                        HYPER['eps'], HYPER['wd'], None, 0.0, 0, 0, None, None,
                                        None)))
        norm = (lambda lib=lib, blocks=blocks, n=len(rows), parts=parts, ticket=ticket:
                lib.launch('adamw_norm', None, dev, (
                    blocks.data_ptr(), gptrs.data_ptr(), 1, n, parts.data_ptr(),
                    ticket.data_ptr(),
                    None, 1.0, 1, 1, ws.data_ptr(), None, ws[5:].data_ptr(), None, None, None,
                    None)))
        calls[name] = (update, norm, blocks, parts, ticket)
        norm()
        norm_err = abs(ws[5].item() / plain_norm - 1)
        copy = {k: [x.clone() for x in v] for k, v in t.items()}
        update()
        adamw.adamw_update_reference(copy['params'], copy['grads'], copy['mus'], copy['nus'],
                                     scalars, **HYPER)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for k in ('params', 'mus', 'nus')
                  for a, b in zip(t[k], copy[k]))
        del copy
        log = (DESIGN_DIR / f'{name}.log').read_text()
        emit({'what': 'design', 'design': name, 'constants': DESIGNS[name],
              'chunk': lib.value('adamw_chunk_elems'), 'norm_rows': lib.value('adamw_norm_rows'),
              'blocks': len(rows), 'registers': re.findall(r'Used (\d+) registers', log),
              'max_abs_err': err, 'norm_rel_err': norm_err}, out)
    order = list(calls) + list(calls)[::-1]
    times = {name: {'update': [], 'norm': []} for name in calls}
    for name in order:
        times[name]['update'].append(device_and_host(calls[name][0])[0])
        times[name]['norm'].append(device_and_host(calls[name][1])[0])
    n = sum(sizes)
    bound = update_bytes(n, torch.float32) / HBM_BYTES_PER_S * 1e3
    norm_bound = 4 * n / HBM_BYTES_PER_S * 1e3
    for name, ms in times.items():
        emit({'what': 'design_time', 'design': name, 'update_device_ms': ms['update'],
              'update_bound_ms': bound, 'norm_device_ms': ms['norm'],
              'norm_bound_ms': norm_bound}, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--label', default='checkout')
    ap.add_argument('--designs', action='store_true')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('adamw_probe: no CUDA device visible')
    out: List[dict] = []
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    _build.build(['flash_fwd', 'flash_bwd', 'adamw'])
    log = Path(f'{_build.library_path("adamw")}.log').read_text()
    emit({'what': 'env', 'label': args.label, 'nvidia_smi': smi, 'torch': torch.__version__,
          'source': str(_build.CSRC / 'adamw.cu'),
          'ptxas': [ln.strip() for ln in log.splitlines()
                    if 'Compiling entry' in ln or 'registers' in ln or 'spill' in ln]}, out)
    for name, moe in (('vit_base', False), ('vit_base_moe', True)):
        shapes = tree_shapes(moe)
        for mu_dtype in (torch.float32, torch.bfloat16):
            emit({'label': args.label, **update_row(name, shapes, mu_dtype)}, out)
    n = sum(s.numel() for s in tree_shapes(moe=False))
    emit({'label': args.label, **copy_row(update_bytes(n, torch.float32))}, out)
    emit({'label': args.label, **train_row()}, out)
    if args.designs:
        design_rows(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(''.join(json.dumps(o) + '\n' for o in out))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
