"""Flash kernels #1-#4 with a band (causal, a left window) and grouped KV
heads on the GPU: their device time beside the FLOPs the band needs, and
their default calls beside another checkout's kernels, bit for bit.

    python -m ecg_representation_learning_tpu_torch.tools.flash_band_probe \\
        [--other ROOT] [--out FILE]

- ``band`` lines: at the Trinity cell's attention, q (2, 32, 8192, 128) and
  k, v (2, 4, 8192, 128) bf16, causal with no window and with the window of
  2,047 keys before the query, and at ViT-base's long records (2, 12, 2048,
  64) bidirectional: the device ms of the forward with lse (#2), of dQ (#3)
  and of dK/dV (#4), each with its FLOP bound (visible (query, key) pairs x D
  x 4, 6 and 8 at the bf16 peak), and the window's time over the full
  layer's.
- with ``--other ROOT`` (a checkout of the port from before the band, e.g.
  a ``git archive`` of the parent commit): its ``flash_fwd.cu`` and
  ``flash_bwd.cu`` built into ``build/flash_other/``, and ``same_bits``
  lines: the default calls of this checkout's kernels (no band, one head
  count) against that build's at chip_smoke.py's kernel shapes, dropout 0
  and 0.1, every output compared bit for bit.

Prints one JSON object per line, and writes them to ``--out`` as well.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..ops import _build
from ..ops import attention as attn

BF16_PEAK = 989e12
REL_FLOOR = 1e-3       # the smallest RMS a norm-relative error is taken over
# chip_smoke.py's KERNEL_CASES: the shapes whose default calls must keep their bits
DEFAULT_CASES = [((64, 12, 41, 64), torch.float32), ((64, 12, 41, 64), torch.bfloat16),
                 ((2, 12, 1024, 64), torch.bfloat16), ((1, 4, 2049, 64), torch.float32),
                 ((3, 5, 200, 80), torch.bfloat16), ((2, 4, 130, 128), torch.float32),
                 ((1, 1, 1, 64), torch.float32), ((8, 12, 128, 64), torch.bfloat16),
                 ((2, 12, 2048, 64), torch.bfloat16), ((2, 8, 1000, 128), torch.bfloat16)]
# (name, q shape, KV heads, causal, window_left)
BAND_CASES = [('trinity_full', (2, 32, 8192, 128), 4, True, -1),
              ('trinity_window', (2, 32, 8192, 128), 4, True, 2047),
              ('vitb_t2048', (2, 12, 2048, 64), 12, False, -1)]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entries before the band: no heads, kv_heads, causal, window
_OLD_TAIL = [_I] * 4 + [_F, _I, _P, _I, _I, _I, _F, _P]
_OLD_FWD = {'flash_fwd': [_P] * 5 + _OLD_TAIL}
_OLD_BWD = {'flash_bwd_dq': [_P] * 7 + _OLD_TAIL, 'flash_bwd_dkv': [_P] * 8 + _OLD_TAIL}


def visible_pairs(t: int, causal: bool, window_left: int) -> int:
    """The (query, key) pairs a head's attention sees: T^2 bidirectional,
    T (T + 1) / 2 causal, and with a causal window of W' = window_left + 1
    keys W' (W' + 1) / 2 + (T - W') W'."""
    if not causal:
        if window_left >= 0:
            raise ValueError('a bidirectional window is not counted here')
        return t * t
    w = window_left + 1 if 0 <= window_left < t else t
    return w * (w + 1) // 2 + (t - w) * w


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``, back to back between two CUDA events (the
    calls here take milliseconds, so the host's launch rate stays hidden)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def band_rows(dev) -> List[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, full = [], {}
    for name, shape, hk, causal, window in BAND_CASES:
        b, h, t, d = shape
        q, do = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, hk, t, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        band = dict(causal=causal, window_left=window)
        out, lse = attn.flash_attention_forward(q, k, v, return_lse=True, **band)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, 0, d ** -0.5, 0.0, 0, causal, window)
        ms = {'fwd_lse': device_ms(lambda: attn.flash_attention_forward(
                  q, k, v, return_lse=True, **band)),
              'dq': device_ms(lambda: attn.flash_bwd_dq_kernel(*args)),
              'dkv': device_ms(lambda: attn.flash_bwd_dkv_kernel(*args))}
        pairs = b * h * visible_pairs(t, causal, window)
        bound = {k: mult * pairs * d / BF16_PEAK * 1e3
                 for k, mult in (('fwd_lse', 4), ('dq', 6), ('dkv', 8))}
        row = {'probe': 'band', 'case': name, 'q': list(shape), 'kv_heads': hk,
               'causal': causal, 'window_left': window, 'visible_pairs': pairs,
               'device_ms': ms, 'bound_ms': bound,
               'of_bound': {k: bound[k] / ms[k] for k in ms}}
        if name == 'trinity_full':
            full = ms
        elif name == 'trinity_window':
            row['over_full'] = {k: ms[k] / full[k] for k in ms}
        rows.append(row)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def band_errors(case, dev, seed: int = 77,
                plain_window: Optional[int] = None) -> Dict[str, float]:
    """The banded kernels against their plain versions for ``case`` (B, H,
    H_kv, T, D, dtype, causal, window_left, dropout rate): the largest error
    of the output (abs), the lse (abs) and each gradient (abs over max(1,
    max |plain|)), and of the output and each gradient the norm of the error
    over the plain result's norm, or over an RMS of REL_FLOOR where the plain
    result is smaller (``*_rel``; with window_left 0 a query sees only
    itself, so dQ and dK are 0 up to rounding); the plain versions run a batch
    row and a KV group at a time (the cell's T x T probabilities are 2 GB a
    head group).  Also whether #1 gave #2's output and every result was
    finite.  ``plain_window`` gives the plain versions another window_left
    than the kernels' (a planted fault at the window's edge)."""
    b, h, hk, t, d, dtype, causal, window, rate = case
    plain_band = dict(causal=causal,
                      window_left=window if plain_window is None else plain_window)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn((b, h, t, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, hk, t, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    band = dict(causal=causal, window_left=window)
    out, lse = attn.flash_attention_forward(q, k, v, seed, None, rate, return_lse=True, **band)
    plain = attn.flash_attention_forward(q, k, v, seed, None, rate, **band)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, seed, d ** -0.5, rate, 0, causal, window)
    dq = attn.flash_bwd_dq_kernel(*args)
    dk, dv = attn.flash_bwd_dkv_kernel(*args)
    torch.cuda.synchronize()

    def rel(got, want):
        want = want.float()
        return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1.0)).item()
    err = dict.fromkeys(('out', 'lse', 'dq', 'dk', 'dv'), 0.0)
    sq = {n: [0.0, 0.0, 0] for n in ('out', 'dq', 'dk', 'dv')}  # |got - want|^2, |want|^2, n
    g = h // hk
    for bi in range(b):
        for j in range(hk):
            qs, hs = slice(j * g, (j + 1) * g), slice(j, j + 1)

            def part(x, s):
                return x[bi:bi + 1, s].contiguous()
            pq, pk, pv, pdo = part(q, qs), part(k, hs), part(v, hs), part(do, qs)
            off = bi * h + j * g     # the rows' bh in the whole batch (their dropout masks)
            want_o, want_lse = attn.flash_attention_forward_reference(
                pq, pk, pv, seed, None, rate, return_lse=True, bh_offset=off, **plain_band)
            pargs = (pq, pk, pv, pdo, part(lse, qs), part(delta, qs), seed, d ** -0.5, rate,
                     off, plain_band['causal'], plain_band['window_left'])
            wk, wv = attn.flash_bwd_dkv_reference(*pargs)
            pairs = {'out': (part(out, qs), want_o),
                     'dq': (part(dq, qs), attn.flash_bwd_dq_reference(*pargs)),
                     'dk': (part(dk, hs), wk), 'dv': (part(dv, hs), wv)}
            now = {'out': (pairs['out'][0].float() - want_o.float()).abs().max().item(),
                   'lse': (part(lse, qs) - want_lse).abs().max().item(),
                   **{n: rel(*pairs[n]) for n in ('dq', 'dk', 'dv')}}
            err = {n: max(err[n], now[n]) for n in err}
            for n, (got, want) in pairs.items():
                sq[n][0] += (got.float() - want.float()).square().sum().item()
                sq[n][1] += want.float().square().sum().item()
                sq[n][2] += want.numel()
    return {**err, **{f'{name}_rel': (e / max(w, count * REL_FLOOR ** 2)) ** 0.5
                      for name, (e, w, count) in sq.items()},
            'fwd_is_lse_fwd': bool(torch.equal(plain, out)),
            'finite': all(bool(torch.isfinite(x).all()) for x in (out, lse, dq, dk, dv))}


def other_libraries(root: Path) -> Tuple[_build.CtypesLibrary, _build.CtypesLibrary]:
    """The flash libraries of the checkout at ``root``, built with this
    checkout's flags into ``build/flash_other/``."""
    csrc = root / 'ecg_representation_learning_tpu_torch' / 'ops' / 'csrc'
    out_dir = _build.BUILD_DIR.parent / 'flash_other'
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, jobs = {}, []
    for name in ('flash_fwd', 'flash_bwd'):
        digest = hashlib.sha1((csrc / f'{name}.cu').read_bytes())
        for header in sorted(csrc.glob('*.cuh')):
            digest.update(header.read_bytes())
        libs[name] = out_dir / f'lib{name}-{digest.hexdigest()[:12]}.so'
        if not libs[name].is_file():
            jobs.append(subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(libs[name]),
                 str(csrc / f'{name}.cu')], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for job in jobs:
        log, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f'nvcc failed on the other checkout:\n{log}')
    return (_build.CtypesLibrary(libs['flash_fwd'], _OLD_FWD),
            _build.CtypesLibrary(libs['flash_bwd'], _OLD_BWD))


def _old_calls(fwd, bwd, q, k, v, do, seed: int, rate: float) -> Dict[str, torch.Tensor]:
    b, h, t, d = q.shape
    tail = (int(q.dtype == torch.bfloat16), d ** -0.5, seed, None, 0,
            *attn._dropout_args(rate))
    out, lse = torch.empty_like(q), torch.empty((b, h, t), device=q.device)
    fwd.launch('flash_fwd', None, q.device, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             out.data_ptr(), lse.data_ptr(), b * h, t, d,
                                             *tail))
    plain = torch.empty_like(q)
    fwd.launch('flash_fwd', None, q.device, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             plain.data_ptr(), None, b * h, t, d, *tail))
    delta = (do.float() * out).sum(-1)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    bwd.launch('flash_bwd_dq', None, q.device, (*common, dq.data_ptr(), b * h, t, d, *tail))
    bwd.launch('flash_bwd_dkv', None, q.device, (*common, dk.data_ptr(), dv.data_ptr(),
                                                 b * h, t, d, *tail))
    return {'out': plain, 'out_lse': out, 'lse': lse, 'dq': dq, 'dk': dk, 'dv': dv}


def _new_calls(q, k, v, do, seed: int, rate: float) -> Dict[str, torch.Tensor]:
    plain = attn.flash_attention_forward(q, k, v, seed, None, rate)
    out, lse = attn.flash_attention_forward(q, k, v, seed, None, rate, return_lse=True)
    delta = (do.float() * out).sum(-1)
    args = (q, k, v, do, lse, delta, seed, q.shape[-1] ** -0.5, rate)
    dk, dv = attn.flash_bwd_dkv_kernel(*args)
    return {'out': plain, 'out_lse': out, 'lse': lse, 'dq': attn.flash_bwd_dq_kernel(*args),
            'dk': dk, 'dv': dv}


def same_bits_rows(root: Path, dev) -> List[dict]:
    """This checkout's default calls against the other checkout's kernels."""
    fwd, bwd = other_libraries(root)
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for shape, dtype in DEFAULT_CASES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        for rate, seed in ((0.0, 0), (0.1, 1234)):
            old = _old_calls(fwd, bwd, q, k, v, do, seed, rate)
            new = _new_calls(q, k, v, do, seed, rate)
            torch.cuda.synchronize()
            rows.append({'probe': 'same_bits', 'shape': list(shape), 'dtype': str(dtype),
                         'dropout_rate': rate,
                         'same': {n: bool(torch.equal(old[n], new[n])) for n in old}})
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--other', default=None, help='root of another checkout of the port')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    dev = torch.device('cuda', 0)
    rows = band_rows(dev)
    if args.other:
        rows += same_bits_rows(Path(args.other), dev)
    lines = [json.dumps(r) for r in rows]
    print('\n'.join(lines), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text('\n'.join(lines) + '\n')
    same = [all(r['same'].values()) for r in rows if r['probe'] == 'same_bits']
    return 0 if all(same) else 1


if __name__ == '__main__':
    raise SystemExit(main())
