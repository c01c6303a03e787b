"""Flash kernels #1-#4 with a band (causal, a left window) and grouped KV
heads on the GPU: their device time beside the FLOPs the band needs, the
warp-specialised backward beside the scalar-load kernels, and the calls
beside another checkout's kernels, bit for bit.

    python -m ecg_representation_learning_tpu_torch.tools.flash_band_probe \\
        [--other ROOT] [--out FILE]

- ``band`` lines: at the Trinity cell's attention, q (2, 32, 8192, 128) and
  k, v (2, 4, 8192, 128) bf16, causal with no window and with the window of
  2,047 keys before the query, and at ViT-base's long records (2, 12, 2048,
  64) bidirectional: the device ms of the forward with lse (#2), of dQ (#3)
  and of dK/dV (#4), each with its FLOP bound (visible (query, key) pairs x D
  x 4, 6 and 8 at the bf16 peak), and the window's time over the full
  layer's.
- ``ws_bits`` lines: at WS_CASES, the aligned bf16 calls of #3 and #4 (the
  warp-specialised kernels, fed by TMA) against the same calls on q and dO
  stored one element off 16 bytes (the scalar-load kernels), dQ, dK and dV
  bit for bit, and the launches each route counted under ``flash_bwd_ws``.
- with ``--other ROOT`` (another checkout of the port, e.g. a ``git
  archive`` of the parent commit): its ``flash_fwd.cu`` and ``flash_bwd.cu``
  built into ``build/flash_other/``, and ``same_bits`` lines: this
  checkout's calls against that build's, every output compared bit for bit,
  at chip_smoke.py's kernel shapes (default calls: no band, one head count)
  and, where the other checkout's entries take the band, at BAND_CASES, at
  dropout 0 and 0.1.

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

# (B, H, H_kv, T, D, causal, window_left, dropout rate) of the ws_bits lines:
# the Trinity cell's full and window layers, the MIM cell's, a ragged head and
# a banded dropout case
WS_CASES = [(2, 32, 4, 8192, 128, True, -1, 0.0), (2, 32, 4, 8192, 128, True, 2047, 0.0),
            (2, 12, 12, 2048, 64, False, -1, 0.0), (3, 6, 3, 200, 80, False, 50, 0.0),
            (2, 16, 4, 777, 128, True, 255, 0.1)]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entries before the band: no heads, kv_heads, causal, window
_OLD_TAIL = [_I] * 4 + [_F, _I, _P, _I, _I, _I, _F, _P]
_BAND_TAIL = [_I] * 4 + _OLD_TAIL


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


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """x stored one element past a 16-byte boundary (a storage offset of one
    element): a call given it takes the kernels' scalar-load route."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def ws_bits(case, dev, seed: int = 77) -> dict:
    """The warp-specialised route (aligned bf16 arrays) of #3 and #4 against
    the scalar-load kernels (q and dO one element off 16 bytes) for ``case``
    (B, H, H_kv, T, D, causal, window_left, dropout rate): whether dQ, dK and
    dV have the same bits, and the launches each route counted under
    ``flash_bwd_ws``."""
    b, h, hk, t, d, causal, window, rate = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, hk, t, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = attn.flash_attention_forward(q, k, v, seed, None, rate, return_lse=True,
                                            causal=causal, window_left=window)
    delta = (do.float() * out.float()).sum(-1)
    tail = (lse, delta, seed, d ** -0.5, rate, 0, causal, window)
    counts = [_build.launch_counts()['flash_bwd_ws']]
    got = {}
    for name, (qq, dd) in (('ws', (q, do)), ('scalar', (unaligned(q), unaligned(do)))):
        got[name] = (attn.flash_bwd_dq_kernel(qq, k, v, dd, *tail),
                     *attn.flash_bwd_dkv_kernel(qq, k, v, dd, *tail))
        counts.append(_build.launch_counts()['flash_bwd_ws'])
    torch.cuda.synchronize()
    return {'probe': 'ws_bits', 'case': [b, h, hk, t, d, causal, window, rate],
            'same': {n: bool(torch.equal(a, c))
                     for n, a, c in zip(('dq', 'dk', 'dv'), got['ws'], got['scalar'])},
            'ws_launches': counts[1] - counts[0], 'scalar_ws_launches': counts[2] - counts[1]}


def other_libraries(root: Path) -> Tuple[_build.CtypesLibrary, _build.CtypesLibrary, bool]:
    """The flash libraries of the checkout at ``root``, built with this
    checkout's flags into ``build/flash_other/``, and whether their entries
    take the band (heads, kv_heads, causal, window)."""
    csrc = root / 'ecg_representation_learning_tpu_torch' / 'ops' / 'csrc'
    banded = 'int kv_heads' in (csrc / 'flash_bwd.cu').read_text()
    tail = _BAND_TAIL if banded else _OLD_TAIL
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
    return (_build.CtypesLibrary(libs['flash_fwd'], {'flash_fwd': [_P] * 5 + tail}),
            _build.CtypesLibrary(libs['flash_bwd'], {'flash_bwd_dq': [_P] * 7 + tail,
                                                     'flash_bwd_dkv': [_P] * 8 + tail}),
            banded)


def _old_calls(fwd, bwd, banded: bool, q, k, v, do, seed: int, rate: float,
               causal: bool = False, window: int = -1) -> Dict[str, torch.Tensor]:
    b, h, t, d = q.shape
    band = (h, k.shape[1], int(causal), window) if banded else ()
    tail = (*band, int(q.dtype == torch.bfloat16), d ** -0.5, seed, None, 0,
            *attn._dropout_args(rate))
    out, lse = torch.empty_like(q), torch.empty((b, h, t), device=q.device)
    fwd.launch('flash_fwd', None, q.device, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             out.data_ptr(), lse.data_ptr(), b * h, t, d,
                                             *tail))
    plain = torch.empty_like(q)
    fwd.launch('flash_fwd', None, q.device, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             plain.data_ptr(), None, b * h, t, d, *tail))
    delta = (do.float() * out).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr())
    bwd.launch('flash_bwd_dq', None, q.device, (*common, dq.data_ptr(), b * h, t, d, *tail))
    bwd.launch('flash_bwd_dkv', None, q.device, (*common, dk.data_ptr(), dv.data_ptr(),
                                                 b * h, t, d, *tail))
    return {'out': plain, 'out_lse': out, 'lse': lse, 'dq': dq, 'dk': dk, 'dv': dv}


def _new_calls(q, k, v, do, seed: int, rate: float, causal: bool = False,
               window: int = -1) -> Dict[str, torch.Tensor]:
    band = dict(causal=causal, window_left=window)
    plain = attn.flash_attention_forward(q, k, v, seed, None, rate, **band)
    out, lse = attn.flash_attention_forward(q, k, v, seed, None, rate, return_lse=True, **band)
    delta = (do.float() * out).sum(-1)
    args = (q, k, v, do, lse, delta, seed, q.shape[-1] ** -0.5, rate, 0, causal, window)
    dk, dv = attn.flash_bwd_dkv_kernel(*args)
    return {'out': plain, 'out_lse': out, 'lse': lse, 'dq': attn.flash_bwd_dq_kernel(*args),
            'dk': dk, 'dv': dv}


def same_bits_rows(root: Path, dev) -> List[dict]:
    """This checkout's calls against the other checkout's kernels: the
    default calls at DEFAULT_CASES and, where the other's entries take the
    band, the banded calls at BAND_CASES."""
    fwd, bwd, banded = other_libraries(root)
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(list(shape), dtype, shape[1], False, -1) for shape, dtype in DEFAULT_CASES]
    if banded:
        cases += [(list(shape), torch.bfloat16, hk, causal, window)
                  for _, shape, hk, causal, window in BAND_CASES]
    rows = []
    for shape, dtype, hk, causal, window in cases:
        b, h, t, d = shape
        q, do = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, hk, t, d), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        for rate, seed in ((0.0, 0), (0.1, 1234)):
            old = _old_calls(fwd, bwd, banded, q, k, v, do, seed, rate, causal, window)
            new = _new_calls(q, k, v, do, seed, rate, causal, window)
            torch.cuda.synchronize()
            rows.append({'probe': 'same_bits', 'shape': shape, 'kv_heads': hk,
                         'dtype': str(dtype), 'causal': causal, 'window_left': window,
                         'dropout_rate': rate,
                         'same': {n: bool(torch.equal(old[n], new[n])) for n in old}})
            del old, new
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--other', default=None, help='root of another checkout of the port')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    dev = torch.device('cuda', 0)
    rows = band_rows(dev) + [ws_bits(case, dev) for case in WS_CASES]
    if args.other:
        rows += same_bits_rows(Path(args.other), dev)
    lines = [json.dumps(r) for r in rows]
    print('\n'.join(lines), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text('\n'.join(lines) + '\n')
    same = [all(r['same'].values()) for r in rows if 'same' in r]
    return 0 if all(same) else 1


if __name__ == '__main__':
    raise SystemExit(main())
