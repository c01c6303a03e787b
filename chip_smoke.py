#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--phases kernels serving training denoise]

Builds every CUDA kernel of the port from ``ops/csrc`` with nvcc, one
process per source started together (into ``build/torch_kernels/``), then:

1. kernel phase, TF32 off: each kernel against its plain PyTorch version on
   the card, with its time beside the plain version's, a library call's
   (which the port never calls) and the least time the card could take --
   the flash forward (#1) and its lse variant (#2) against
   ``scaled_dot_product_attention``, the blocked backward dQ (#3) and dK/dV
   (#4) against SDPA's backward, at the serving shape and at longer
   sequences (ragged T and D, one row, exact tiles, rows of a size that
   takes the kernel's scalar-load branch), f32 and bf16, dropout 0 and 0.1,
   and the dropout masks of #1 to #4 checked entry by entry against
   ``keep_full``; #3 and #4 also as one backward (with the delta reduction)
   beside SDPA's backward and the plain recompute, in device time; AdamW (#5)
   over every
   ViT-base leaf for three steps (plain, clip engaged, non-finite), f32 and
   bf16 mu, against ``torch.optim.AdamW(fused=True)``; the NLM kernel (#6)
   on the denoise chain's rows of 64 records at full and bounded search, on
   ragged rows with a zero row and on rows longer than one block's segment;
   its five attribution variants (#7), then the probe
   ``tools/nlm_sol_probe.py`` of the port;
2. serving phase: ViT-base (f32, 12 layers of attention at 41 tokens, all
   through the kernel: ``flash_min_seq=0``) behind ``serving.serve`` answers
   16 concurrent HTTP requests; every client's rows must equal
   ``predict_long`` of its own input and a forward through plain attention,
   and the kernel's launch count must show the requests went through it;
   then the bs-64 predict throughput with the kernel and with plain
   attention, a profile of that predict, and the check once more with bf16
   Linear layers;
3. training phase: ViT-base with ``flash_min_seq=0`` and a blocked-backward
   threshold of 0, so every step runs 12 lse forwards, 12 dQ, 12 dK/dV and
   one AdamW launch: three f32 steps against a plain twin (plain attention,
   plain AdamW) from one init, then ``Trainer.train()`` in bf16 with dropout
   0.1 and TimeOut over 2 epochs of the hard synthetic corpus, with its
   train samples/s, eval macro-AUROC and a profile of one step;
4. denoise phase: ``export_denoised``'s per-chunk body (``denoise_chunk``)
   on synthetic 12 x 2500 records at 250 Hz: two chunks of 64 at full search
   (the CLI default) and one at search 128, one NLM launch each; records/s,
   the device time of each chain step and a profile; the output against a
   twin whose NLM step is the plain version and against the chain on the
   CPU; an all-zero lead comes out all zeros.

Every phase raises on a failed check.  Prints one JSON object per line; the
line before the last lists the kernels, the last is the result (printed only
when every phase ran).  Exits non-zero, printing no result, when no GPU is
visible.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from ecg_representation_learning_tpu_torch.configs import (PreprocessConfig, TrainConfig,
                                                           VitConfig)
from ecg_representation_learning_tpu_torch.data import get_ptbxl_splits, synth_ecg, synth_ptbxl
from ecg_representation_learning_tpu_torch.data.export import denoise_chunk
from ecg_representation_learning_tpu_torch.models.vit import EcgVit
from ecg_representation_learning_tpu_torch.ops import _build, adamw, nlm_fused
from ecg_representation_learning_tpu_torch.ops import attention as attn
from ecg_representation_learning_tpu_torch.ops.filter import butterworth_low_pass
from ecg_representation_learning_tpu_torch.ops.loess import rloess
from ecg_representation_learning_tpu_torch.ops.preprocess import zheng_denoise, zheng_detrend
from ecg_representation_learning_tpu_torch.registry import PTBXL_TRAIN_STATS
from ecg_representation_learning_tpu_torch.serving import serve
from ecg_representation_learning_tpu_torch.tools import nlm_sol_probe as probe
from ecg_representation_learning_tpu_torch.train import SplitData, Trainer

# H100 SXM data sheet: HBM rate, and the dense peak for each input type
# (f32 on the CUDA cores, bf16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel vs plain version, max abs error: f32 differs only in summation
# order; bf16 also in where p is rounded (before vs after normalization)
LIMITS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SERVING_SHAPE = (64, 12, 41, 64)     # ViT-base at bs 64: B, H, T = 40 patches + cls, D
# the serving shape, long sequences, ragged T with D = 80 and 128 (the
# kernels' 128-column tiles), one row, exact tiles, about a bs-64 batch's
# tokens at T = 256, and rows of 40 and 132 bytes (the scalar-load branch)
KERNEL_CASES = [(SERVING_SHAPE, torch.float32), (SERVING_SHAPE, torch.bfloat16),
                ((2, 12, 1024, 64), torch.bfloat16), ((1, 4, 2049, 64), torch.float32),
                ((3, 5, 200, 80), torch.bfloat16), ((2, 4, 130, 128), torch.float32),
                ((1, 1, 1, 64), torch.float32), ((8, 12, 128, 64), torch.bfloat16),
                ((10, 12, 256, 64), torch.bfloat16), ((2, 3, 100, 20), torch.bfloat16),
                ((2, 3, 77, 33), torch.float32)]
# the dropout mask check: sequence lengths, (B, H), rate
MASK_TS, MASK_BH, MASK_RATE = (41, 256), (2, 6), 0.1
# backward kernels vs plain version, max abs error over max(1, max |plain|):
# f32 sums in another order (the CPU tests hold the plain version to JAX at
# 2e-5 the same way); bf16 rounds ds and the outputs to 8 significant bits
BWD_LIMITS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_LIMIT = 1e-5                     # row log-sum-exp, f32 in both dtypes
ADAMW_LIMIT = 0.0                    # the kernel repeats the plain version's
                                     # IEEE operations in order: bit for bit
SERVING_TOL = 1e-4                   # probabilities, kernel vs plain attention, f32
BF16_TOL = 2e-2                      # the same in bf16: 8 significant bits
N_CLIENTS = 16
PARITY_STEPS = 3
LOSS_RTOL = 1e-4                     # per-step loss, kernels vs plain twin, f32
# parameters after PARITY_STEPS steps, kernels vs plain twin: an Adam step
# moves a weight by lr * (|mu_hat| / sqrt(nu_hat) + wd * |p|), about lr, so a
# gradient element at rounding level whose sign differs between the twins
# can end 2 * lr apart per step; every other element agrees to ~1e-6
PARAM_TOL = 2 * PARITY_STEPS * 3e-4 * 1.1
TRAIN_N = 832                        # hard corpus: 644 train rows, 10 steps/epoch at bs 64
# NLM kernel vs plain version, max abs error over max |x|: the JAX package's
# bar between its kernel and the scan form (tests/test_nlm_pallas.py:22);
# the box sums and accumulations are taken in another order
NLM_LIMIT = 2e-6
# operations per weight the NLM needs, from the TPU kernel's body for one
# (row, position, s): SSD 3 (sub, square, mask), box sum 6 (a log tree of
# adds), scale 2, exp 1, masks 3, accumulations 2 x 3 (+s and -s terms)
NLM_OPS = 21
DENOISE_CHUNK = 64                   # export_denoised's --batch default: 768 rows
DENOISE_FQS, DENOISE_LEN = 250, 2500  # the combined export's grid: 10 s records
# kernel #6's other cases: ragged rows (rows, L, search, pw) with an all-zero
# row, and rows longer than one block's 4096-position segment
NLM_RAGGED = (77, 1999, 64, 7)
NLM_LONG = (24, 9000, 5000, 10)
DEV = 'cuda'
# chain on the card vs on the CPU, over max |x|: the LOESS solve and the
# noise estimate's medians see f32 sums in another order on each device
DENOISE_CPU_LIMIT = 1e-4
# (name in the kernels line, source under ops/csrc, the TPU kernel it replaces)
KERNELS = [
    ('flash_fwd', 'flash_fwd', 'ecg_representation_learning_tpu/ops/attention.py:87'),
    ('flash_fwd_lse', 'flash_fwd', 'ecg_representation_learning_tpu/ops/attention.py:142'),
    ('flash_bwd_dq', 'flash_bwd', 'ecg_representation_learning_tpu/ops/attention.py:235'),
    ('flash_bwd_dkv', 'flash_bwd', 'ecg_representation_learning_tpu/ops/attention.py:277'),
    ('adamw', 'adamw', 'ecg_representation_learning_tpu/ops/adamw_pallas.py:41'),
    ('nlm_rows', 'nlm', 'ecg_representation_learning_tpu/ops/nlm_pallas.py:48'),
    ('nlm_variant', 'nlm', 'tools/nlm_sol_probe.py:36'),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events; inputs stay in L2 when they fit)."""
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


# cycles of the spin kernel that device_ms queues calls behind: ~50 ms at
# the H100's 1.98 GHz boost clock, longer than queueing 50 calls of any
# version timed here
SPIN_CYCLES = 100_000_000


def device_ms(fn, reps: int = 50, warmup: int = 5):
    """Device time of ``fn`` per call with the host's launch rate out of the
    way: the calls are queued behind a spin kernel, so the device runs them
    back to back (CUDA events).  None if queueing them outlasted the spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    events[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    events[2].record()
    events[2].synchronize()
    if queued_ms >= events[0].elapsed_time(events[1]):
        return None
    return events[1].elapsed_time(events[2]) / reps


def time_calls(row, calls) -> None:
    """``row[f'{name}_ms']`` (per call, back to back) and
    ``row[f'{name}_device_ms']`` for each of ``calls`` {name: fn}; the plain
    version gets 20 reps, the rest 50."""
    for name, fn in calls.items():
        reps = 20 if name == 'plain' else 50
        row[f'{name}_ms'] = time_ms(fn, reps=reps)
        row[f'{name}_device_ms'] = device_ms(fn, reps=reps)


def bound(n_bytes, n_ops, dtype):
    """Least time for ``n_bytes`` moved at the HBM rate and ``n_ops`` at the
    peak rate for ``dtype``: (ms, 'bytes' | 'operations')."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


def flash_bound(shape, dtype, lse=False):
    """Least time for one flash forward: q, k, v read once and o (and with
    ``lse`` the f32 row lse) written once, against 4*B*H*T^2*D operations
    (two products)."""
    b, h, t, d = shape
    elem = torch.finfo(dtype).bits // 8
    return bound(4 * b * h * t * d * elem + (4 * b * h * t if lse else 0),
                 4 * b * h * t * t * d, dtype)


def flash_bwd_bound(shape, dtype, kernel):
    """Least time for a backward kernel: q, k, v, dO read once with the f32
    lse and delta, and dQ (``'dq'``: 6*B*H*T^2*D operations) or dK and dV
    (``'dkv'``: 8*B*H*T^2*D) written once."""
    b, h, t, d = shape
    elem = torch.finfo(dtype).bits // 8
    n_out, ops = (1, 6) if kernel == 'dq' else (2, 8)
    return bound((4 + n_out) * b * h * t * d * elem + 2 * 4 * b * h * t,
                 ops * b * h * t * t * d, dtype)


def kernel_phase():
    """Kernel against its plain version at every case; returns the serving
    shape's f32 row."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows, failures = [], []
    for shape, dtype in KERNEL_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                   for _ in range(3))
        for rate, seed in ((0.0, 0), (0.1, 1234)):
            got = attn.flash_attention_forward(q, k, v, seed=seed, dropout_rate=rate)
            torch.cuda.synchronize()
            want = attn.flash_attention_forward_reference(q, k, v, seed=seed,
                                                          dropout_rate=rate)
            err = (got.float() - want.float()).abs().max().item()
            bound_ms, bound_by = flash_bound(shape, dtype)
            row = {'phase': 'kernel', 'shape': list(shape), 'dtype': str(dtype),
                   'dropout_rate': rate, 'max_abs_err': err,
                   'limit': LIMITS[dtype], 'finite': bool(torch.isfinite(got).all()),
                   'bound_ms': bound_ms, 'bound_by': bound_by}
            if rate == 0.0:
                time_calls(row, {
                    'kernel': lambda: attn.flash_attention_forward(q, k, v),
                    'plain': lambda: attn.flash_attention_forward_reference(q, k, v),
                    'library': lambda: F.scaled_dot_product_attention(q, k, v)})
            emit(row)
            rows.append(row)
            if not (row['finite'] and err <= LIMITS[dtype]):
                failures.append(row)
    if failures:
        raise AssertionError(f'flash kernel disagrees with its plain version: {failures}')
    return next(r for r in rows if r['shape'] == list(SERVING_SHAPE)
                and r['dtype'] == str(torch.float32) and r['dropout_rate'] == 0.0)


def dropout_mask_phase():
    """The dropout mask of kernels #1 and #2, exactly: with q = k = 0 every
    score is 0 and p = 1/T, and with v one-hot over a 64-key window
    (v[w + c, c] = 1) output column c is nonzero iff key w + c is kept.  The
    nonzero pattern must equal ``keep_full``'s at every (bh, query, key), so
    a wrong fragment -> (qpos, kpos) map cannot hide inside a tolerance."""
    b, h = MASK_BH
    rows = []
    for t in MASK_TS:
        keep = attn.keep_full(4321, b, h, t, MASK_RATE, device='cuda')
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.zeros((b, h, t, 64), device='cuda', dtype=dtype)
            mismatches = {'flash_fwd': 0, 'flash_fwd_lse': 0}
            for w in range(0, t, 64):
                n = min(64, t - w)
                v = torch.zeros_like(q)
                v[:, :, w + torch.arange(n, device='cuda'), torch.arange(n, device='cuda')] = 1
                want = torch.zeros((b, h, t, 64), dtype=torch.bool, device='cuda')
                want[..., :n] = keep[..., w:w + n]
                for name, lse in (('flash_fwd', False), ('flash_fwd_lse', True)):
                    got = attn.flash_attention_forward(q, q, v, 4321, None, MASK_RATE,
                                                       return_lse=lse)
                    got = got[0] if lse else got
                    mismatches[name] += int(((got != 0) != want).sum().item())
            row = {'phase': 'kernel_dropout_mask', 'shape': [b, h, t, 64],
                   'dtype': str(dtype), 'dropout_rate': MASK_RATE,
                   'kept_share': keep.float().mean().item(), 'mismatches': mismatches}
            emit(row)
            rows.append(row)
    if any(sum(r['mismatches'].values()) for r in rows):
        raise AssertionError(f'flash kernels drop other entries than keep_full: {rows}')


def _rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in f32."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def bwd_dropout_mask_phase():
    """The dropout mask of kernels #3 and #4, exactly.  lse = log T and
    delta = 0 passed in make p = 1/T wherever q.k = 0, and with v = dO = e0
    every dpv is 1, so ds is keep / (1 - rate) / T:
      dQ: q = 0, k one-hot over a 64-key window (k[w + c, c] = 1): dQ[i, c]
          is nonzero iff query i keeps key w + c;
      dK: k = 0, q one-hot over a window of queries: dK[j, c] is nonzero
          iff query w + c keeps key j;
      dV: q = k = v = 0, dO one-hot over a window of queries: dV[j, c] =
          p_eff[w + c, j], nonzero iff query w + c keeps key j.
    Each nonzero pattern must equal ``keep_full``'s, so a wrong fragment ->
    (qpos, kpos) map cannot hide inside a tolerance."""
    b, h = MASK_BH
    rows = []
    for t in MASK_TS:
        keep = attn.keep_full(4321, b, h, t, MASK_RATE, device=DEV)
        lse = torch.full((b, h, t), math.log(t), device=DEV)
        delta = torch.zeros((b, h, t), device=DEV)
        for dtype in (torch.float32, torch.bfloat16):
            zero = torch.zeros((b, h, t, 64), device=DEV, dtype=dtype)
            e0 = zero.clone()
            e0[..., 0] = 1
            mismatches = {'flash_bwd_dq': 0, 'flash_bwd_dk': 0, 'flash_bwd_dv': 0}
            for w in range(0, t, 64):
                n = min(64, t - w)
                idx = torch.arange(n, device=DEV)
                window = zero.clone()
                window[:, :, w + idx, idx] = 1

                def run(kernel, q, k, v, do):
                    return kernel(q, k, v, do, lse, delta, 4321, 0.125, MASK_RATE)
                got = {'flash_bwd_dq': run(attn.flash_bwd_dq_kernel, zero, window, e0, e0),
                       'flash_bwd_dk': run(attn.flash_bwd_dkv_kernel, window, zero, e0, e0)[0],
                       'flash_bwd_dv': run(attn.flash_bwd_dkv_kernel, zero, zero, zero, window)[1]}
                want_q = torch.zeros((b, h, t, 64), dtype=torch.bool, device=DEV)
                want_q[..., :n] = keep[..., w:w + n]
                want_kv = torch.zeros_like(want_q)
                want_kv[..., :n] = keep[:, :, w:w + n, :].transpose(-1, -2)
                for name, x in got.items():
                    want = want_q if name == 'flash_bwd_dq' else want_kv
                    mismatches[name] += int(((x != 0) != want).sum().item())
            row = {'phase': 'kernel_bwd_dropout_mask', 'shape': [b, h, t, 64],
                   'dtype': str(dtype), 'dropout_rate': MASK_RATE,
                   'kept_share': keep.float().mean().item(), 'mismatches': mismatches}
            emit(row)
            rows.append(row)
    if any(sum(r['mismatches'].values()) for r in rows):
        raise AssertionError(f'backward kernels drop other entries than keep_full: {rows}')


def sdpa_backward_device_ms(q, k, v, do):
    """Device ms of ``scaled_dot_product_attention``'s backward through
    autograd: forward + backward, minus the forward, each queued behind the
    spin (``device_ms``; the port never calls it).  None if either timing
    outlasted the spin."""
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg).backward(do)
    both = device_ms(fwd_bwd, reps=20)
    with torch.no_grad():
        fwd = device_ms(lambda: F.scaled_dot_product_attention(qg, kg, vg), reps=20)
    return None if both is None or fwd is None else both - fwd


def bwd_pair_row(shape, dtype, q, k, v, do, out, lse, sdpa_ms) -> dict:
    """Kernels #3 and #4 as the gradient runs them (the delta reduction,
    then dQ and dK/dV: ``flash_attention_backward_blocked``) against SDPA's
    backward and the plain f32 recompute that the default path runs below
    ``BLOCKED_BWD_MIN_SEQ``, all in device time at dropout 0."""
    blocked = device_ms(lambda: attn.flash_attention_backward_blocked(q, k, v, out, lse, do))
    recompute = device_ms(lambda: attn.flash_backward_recompute(q, k, v, do), reps=20)
    return {'phase': 'kernel_bwd_pair', 'shape': list(shape), 'dtype': str(dtype),
            'blocked_device_ms': blocked, 'sdpa_backward_device_ms': sdpa_ms,
            'recompute_device_ms': recompute,
            'blocked_over_sdpa': (blocked / sdpa_ms if blocked and sdpa_ms else None)}


def flash_grad_phase():
    """Kernels #2-#4 against their plain versions at every case, rates 0 and
    0.1: the forward's (out, lse), then dQ and (dK, dV) from the same lse
    and delta.  Times at rate 0, and a row for #3 + #4 as one backward.
    Returns {kernel: serving-shape f32 row}."""
    gen = torch.Generator(device='cuda').manual_seed(1)
    rows, failures = {}, []
    for shape, dtype in KERNEL_CASES:
        q, k, v, do = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                       for _ in range(4))
        for rate, seed in ((0.0, 0), (0.1, 4321)):
            out, lse = attn.flash_attention_forward(q, k, v, seed, None, rate,
                                                    return_lse=True)
            torch.cuda.synchronize()
            out_p, lse_p = attn.flash_attention_forward_reference(
                q, k, v, seed, None, rate, return_lse=True)
            delta = (do.float() * out_p.float()).sum(-1)
            args = (q, k, v, do, lse_p, delta, seed, shape[-1] ** -0.5, rate)
            got = {'flash_fwd_lse': (out, lse),
                   'flash_bwd_dq': (attn.flash_bwd_dq_kernel(*args),),
                   'flash_bwd_dkv': attn.flash_bwd_dkv_kernel(*args)}
            torch.cuda.synchronize()
            want = {'flash_fwd_lse': (out_p, lse_p),
                    'flash_bwd_dq': (attn.flash_bwd_dq_reference(*args),),
                    'flash_bwd_dkv': attn.flash_bwd_dkv_reference(*args)}
            for name in got:
                if name == 'flash_fwd_lse':
                    errs = [(out.float() - out_p.float()).abs().max().item(),
                            (lse - lse_p).abs().max().item()]
                    ok = errs[0] <= LIMITS[dtype] and errs[1] <= LSE_LIMIT
                    b_ms, b_by = flash_bound(shape, dtype, lse=True)
                else:
                    rel = [_rel_err(g, w) for g, w in zip(got[name], want[name])]
                    errs = [(g.float() - w.float()).abs().max().item()
                            for g, w in zip(got[name], want[name])]
                    ok = max(rel) <= BWD_LIMITS[dtype]
                    b_ms, b_by = flash_bwd_bound(shape, dtype, name.split('_')[-1])
                finite = all(bool(torch.isfinite(x).all()) for x in got[name])
                row = {'phase': 'kernel', 'kernel': name, 'shape': list(shape),
                       'dtype': str(dtype), 'dropout_rate': rate,
                       'max_abs_err': max(errs), 'errs': errs, 'finite': finite,
                       'bound_ms': b_ms, 'bound_by': b_by}
                if name != 'flash_fwd_lse':
                    row.update(rel_errs=rel, rel_limit=BWD_LIMITS[dtype])
                if rate == 0.0:
                    if name == 'flash_fwd_lse':
                        time_calls(row, {
                            'kernel': lambda: attn.flash_attention_forward(
                                q, k, v, return_lse=True),
                            'plain': lambda: attn.flash_attention_forward_reference(
                                q, k, v, return_lse=True),
                            'library': lambda: F.scaled_dot_product_attention(q, k, v)})
                    else:
                        kern = getattr(attn, f'{name}_kernel')
                        ref = getattr(attn, f'{name}_reference')
                        time_calls(row, {'kernel': lambda: kern(*args),
                                         'plain': lambda: ref(*args)})
                        if name == 'flash_bwd_dq':    # after the kernel's own times
                            sdpa_ms = sdpa_backward_device_ms(q, k, v, do)
                        row['library_ms'] = sdpa_ms
                emit(row)
                if shape == SERVING_SHAPE and dtype == torch.float32 and rate == 0.0:
                    rows[name] = row
                if not (finite and ok):
                    failures.append(row)
            if rate == 0.0:
                emit(bwd_pair_row(shape, dtype, q, k, v, do, out, lse, sdpa_ms))
    if failures:
        raise AssertionError(f'flash lse/backward kernels disagree with their plain '
                             f'versions: {failures}')
    return rows


def adamw_phase():
    """Kernel #5 against its plain version on every ViT-base leaf over three
    steps (plain, clip engaged, non-finite), with f32 and with bf16 mu; its
    time beside the plain version's and ``torch.optim.AdamW(fused=True)``'s
    on the same tensors.  Returns the f32-mu row."""
    with torch.device('meta'):
        shapes = [p.shape for p in EcgVit(VitConfig.from_defined('base')).parameters()]
    n_params = sum(s.numel() for s in shapes)
    gen = torch.Generator(device='cuda').manual_seed(2)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
    steps = [(1.0, 1.0), (0.37, 1.0), (1.0, 0.0)]      # (clip scale, finite)
    out = None
    for mu_dtype in (torch.float32, torch.bfloat16):
        def leaves(fn):
            return [fn(s) for s in shapes]
        params = leaves(lambda s: torch.randn(s, generator=gen, device='cuda'))
        mus = leaves(lambda s: torch.zeros(s, device='cuda', dtype=mu_dtype))
        nus = leaves(lambda s: torch.zeros(s, device='cuda'))
        twin = [[x.clone() for x in xs] for xs in (params, mus, nus)]
        errs = []
        for count, (scale, finite) in enumerate(steps, start=1):
            grads = leaves(lambda s: torch.randn(s, generator=gen, device='cuda'))
            if not finite:
                grads[0].view(-1)[0] = float('nan')
            scalars = torch.tensor([scale, 3e-4, 1 - 0.9 ** count, 1 - 0.999 ** count,
                                    finite], dtype=torch.float32, device='cuda')
            adamw.adamw_update(params, grads, mus, nus, scalars, **hyper)
            torch.cuda.synchronize()
            adamw.adamw_update_reference(*twin[:1], grads, *twin[1:], scalars, **hyper)
            errs.append(max((a.float() - b.float()).abs().max().item()
                            for xs, ys in zip((params, mus, nus), twin)
                            for a, b in zip(xs, ys)))
        finite_ok = all(bool(torch.isfinite(p).all()) for p in params)
        mu_bytes = torch.finfo(mu_dtype).bits // 8
        b_ms, b_by = bound(n_params * (4 * 5 + 2 * mu_bytes), 15 * n_params, torch.float32)
        row = {'phase': 'kernel', 'kernel': 'adamw', 'leaves': len(shapes),
               'params': n_params, 'mu_dtype': str(mu_dtype), 'max_abs_err': max(errs),
               'errs_per_step': errs, 'finite': finite_ok, 'bound_ms': b_ms,
               'bound_by': b_by, 'kernel_ms': time_ms(
                   lambda: adamw.adamw_update(params, grads, mus, nus, scalars, **hyper),
                   reps=20),
               'plain_ms': time_ms(lambda: adamw.adamw_update_reference(
                   *twin[:1], grads, *twin[1:], scalars, **hyper), reps=5)}
        if mu_dtype == torch.float32:
            lib = [torch.nn.Parameter(p.clone()) for p in params]
            for p, g in zip(lib, grads):
                p.grad = g
            opt = torch.optim.AdamW(lib, lr=3e-4, weight_decay=1e-2, fused=True)
            row['library_ms'] = time_ms(opt.step, reps=20)
            del lib, opt
            out = row
        emit(row)
        if not (finite_ok and max(errs) <= ADAMW_LIMIT):
            raise AssertionError(f'adamw kernel disagrees with its plain version: {row}')
        del params, mus, nus, twin, grads
        torch.cuda.empty_cache()
    return out


def nlm_bound(rows: int, n: int, sch: int, pw: int):
    """Least time for one NLM launch: x and 1/h read once, the output
    written once, against NLM_OPS operations per weight that the rows need
    (``nlm_fused.needed_weights``) at the f32 CUDA-core peak."""
    return bound(4 * (2 * rows * n + rows),
                 NLM_OPS * rows * nlm_fused.needed_weights(n, sch, pw), torch.float32)


def _events_ms(fn):
    """(result, device ms) of one call of ``fn``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _nlm_err(got, want, x, zero_rows=()):
    """max |got - want| over max |x|, off the all-zero rows, whose interior
    must be NaN in both (h = 0) and whose edges pass through."""
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    keep[list(zero_rows)] = False
    for r in zero_rows:
        for out in (got, want):
            if not (torch.isnan(out[r, 1:-1]).any() and (out[r, :1] == 0).all()):
                raise AssertionError(f'all-zero row {r} is not NaN inside: {out[r, :20]}')
    err = (got[keep] - want[keep]).abs().max() / x.abs().max()
    return err.item(), bool(torch.isfinite(got[keep]).all())


def chain_rows():
    """The denoise chain's NLM input for one chunk of synthetic records
    (low-pass and robust LOESS on the card): rows (768, 2500) and their
    bandwidths."""
    x = synth_ecg(np.random.default_rng(8), DENOISE_CHUNK, length=DENOISE_LEN,
                  fqs=DENOISE_FQS)
    y = zheng_detrend(torch.from_numpy(x).to(DEV), DENOISE_FQS)
    return y.reshape(-1, DENOISE_LEN), nlm_fused.nlm_bandwidth(y).reshape(-1)


def nlm_phase(y2, h2):
    """Kernel #6 against ``nlm_rows_reference``: the denoise chain's rows
    ``y2`` (768, 2500) with bandwidths ``h2`` at full search (the CLI
    default) and at search 128; ragged rows (77 x 1999, pw 7, search 64)
    with an all-zero row; rows longer than one block's segment (24 x 9000,
    search 5000).  Returns the full-search row."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    (r1, n1, s1, p1), (r2, n2, s2, p2) = NLM_RAGGED, NLM_LONG
    ragged = 10 * torch.randn((r1, n1), generator=gen, device=DEV)
    ragged[5] = 0.0
    long_rows = torch.randn((r2, n2), generator=gen, device=DEV)
    cases = [('chain_full', y2, h2, y2.shape[1], 10, ()),
             ('chain_128', y2, h2, 128, 10, ()),
             ('ragged_zero_row', ragged, nlm_fused.nlm_bandwidth(ragged, 1.5, p1), s1, p1, (5,)),
             ('long_rows', long_rows, nlm_fused.nlm_bandwidth(long_rows, 1.5, p2), s2, p2, ())]
    rows, failures = {}, []
    for name, x, h, sch, pw, zero_rows in cases:
        got = nlm_fused.nlm_rows(x, h, sch, pw)
        torch.cuda.synchronize()
        want, plain_once = _events_ms(lambda: nlm_fused.nlm_rows_reference(x, h, sch, pw))
        err, finite = _nlm_err(got, want, x, zero_rows)
        b_ms, b_by = nlm_bound(x.shape[0], x.shape[1], sch, pw)
        row = {'phase': 'kernel', 'kernel': 'nlm_rows', 'case': name,
               'shape': list(x.shape), 'sch_wd': sch, 'patch_wd': pw,
               'max_abs_err': err, 'limit': NLM_LIMIT, 'finite': finite,
               'zero_rows_nan': list(zero_rows), 'bound_ms': b_ms, 'bound_by': b_by,
               'kernel_ms': time_ms(lambda: nlm_fused.nlm_rows(x, h, sch, pw),
                                    reps=5 if sch > 1000 else 20, warmup=1),
               'plain_ms': (plain_once if sch > 1000 else time_ms(
                   lambda: nlm_fused.nlm_rows_reference(x, h, sch, pw), reps=3, warmup=1)),
               'plain_timed': 'once' if sch > 1000 else 'mean of 3',
               'library_ms': None,
               'library': 'none: no single PyTorch call computes non-local means'}
        emit(row)
        rows[name] = row
        if not (finite and err <= NLM_LIMIT):
            failures.append(row)
    if failures:
        raise AssertionError(f'nlm kernel disagrees with its plain version: {failures}')
    return rows['chain_full']


def nlm_variant_phase():
    """Kernel #7: each attribution variant against its plain version at the
    probe's shape (768, 2500, search 128, pw 10, N(0, 1) rows, h = 1), then
    the probe's own timing run (its launches are this kernel's main path)
    and its attribution.  Returns the 'full' variant's row."""
    r, n, sch, pw = probe.SHAPE
    gen = torch.Generator(device=DEV).manual_seed(4)
    x = torch.randn((r, n), generator=gen, device=DEV)
    h = torch.ones(r, device=DEV)
    b_ms, b_by = nlm_bound(r, n, sch, pw)
    rows, failures = {}, []
    for name, flags in probe.VARIANTS:
        got = probe.run_variant(x, h, sch, pw, flags)
        torch.cuda.synchronize()
        want = probe.variant_reference(x, h, sch, pw, flags)
        err, finite = _nlm_err(got, want, x)
        row = {'phase': 'kernel', 'kernel': 'nlm_variant', 'variant': name,
               'shape': [r, n], 'sch_wd': sch, 'patch_wd': pw, 'max_abs_err': err,
               'limit': NLM_LIMIT, 'finite': finite, 'bound_ms': b_ms, 'bound_by': b_by,
               'kernel_ms': time_ms(lambda: probe.run_variant(x, h, sch, pw, flags),
                                    reps=20, warmup=1),
               'plain_ms': time_ms(lambda: probe.variant_reference(x, h, sch, pw, flags),
                                   reps=3, warmup=1),
               'library_ms': None}
        emit(row)
        rows[name] = row
        if not (finite and err <= NLM_LIMIT):
            failures.append(row)
    if failures:
        raise AssertionError(f'nlm variants disagree with their plain versions: {failures}')
    probe.variant_kernel.launches = 0
    times = probe.measure()
    launches = probe.variant_kernel.launches
    emit({'phase': 'nlm_sol_probe', 'shape': list(probe.SHAPE), 'ms': times,
          'attribution_ms': probe.attribution(times),
          'attribution_share': {k: v / times['full'] for k, v in
                                probe.attribution(times).items()},
          'launches': launches})
    full = dict(rows['full'], launches=launches,
                max_abs_err=max(row['max_abs_err'] for row in rows.values()))
    return full


def _chunk_split(x, cfg, emit_profiles):
    """Each chain step on one chunk, profiled alone after a warm-up call
    (see ``_profile``): low-pass, rloess (6 smooths, 10 medians), the noise
    estimate (2 medians) and the NLM kernel.  Returns {step: device ms, wall
    ms, device launches}; emits each step's profile if asked."""
    y1 = butterworth_low_pass(x, fs=DENOISE_FQS)
    y = (y1 - rloess(y1, n=DENOISE_FQS, robust_iters=cfg.loess_robust_iters)
         ).reshape(-1, x.shape[-1])
    h = nlm_fused.nlm_bandwidth(y, cfg.nlm_smooth_factor, cfg.nlm_patch_halfwidth)
    sch = cfg.nlm_search_width or x.shape[-1]
    steps = {'lowpass': lambda: butterworth_low_pass(x, fs=DENOISE_FQS),
             'rloess': lambda: rloess(y1, n=DENOISE_FQS, robust_iters=cfg.loess_robust_iters),
             'sigma': lambda: nlm_fused.nlm_bandwidth(y, cfg.nlm_smooth_factor,
                                                      cfg.nlm_patch_halfwidth),
             'nlm': lambda: nlm_fused.nlm_rows(y, h, sch, cfg.nlm_patch_halfwidth)}
    split = {}
    for name, step in steps.items():
        def run(step=step):
            step()
            torch.cuda.synchronize()
        run()
        prof = _profile(f'denoise step {name}, chunk of {DENOISE_CHUNK} records, '
                        f'search {sch}', 'call', 1, run)
        split[name] = {'device_ms': prof['device_ms_per_call'],
                       'wall_ms': prof['wall_ms_per_call'],
                       'launches': prof['device_launches_per_call']}
        if emit_profiles:
            emit(prof)
    return split


def denoise_phase():
    """``export_denoised``'s per-chunk body on the card at the CLI defaults:
    two chunks of 64 records at full search, one at search 128.  Returns
    the NLM kernel's launches in those three runs (one per chunk)."""
    rng = np.random.default_rng(7)
    x = synth_ecg(rng, 3 * DENOISE_CHUNK, length=DENOISE_LEN, fqs=DENOISE_FQS)
    zero_lead = (5, 4)                   # record 5 of the first chunk: lead 4 all zero
    x[zero_lead] = 0.0
    full, bounded = PreprocessConfig(), PreprocessConfig(nlm_search_width=128)
    denoise_chunk(x[:2, :, :500], DENOISE_FQS, bounded, DEV)  # warm-up: cuBLAS, library
    _zero_counts()
    runs, outs = [], []
    for i, cfg in enumerate((full, full, bounded)):
        chunk = x[i * DENOISE_CHUNK:(i + 1) * DENOISE_CHUNK]
        before = nlm_fused.nlm_rows_kernel.launches
        t0 = time.perf_counter()
        outs.append(denoise_chunk(chunk, DENOISE_FQS, cfg, DEV))
        seconds = time.perf_counter() - t0
        runs.append({'chunk': i, 'records': len(chunk),
                     'nlm_search_width': cfg.nlm_search_width or DENOISE_LEN,
                     'seconds': seconds, 'records_per_s': len(chunk) / seconds,
                     'nlm_launches': nlm_fused.nlm_rows_kernel.launches - before})
    launches = _counts()
    emit({'phase': 'denoise', 'runs': runs, 'launches': launches})
    if [r['nlm_launches'] for r in runs] != [1, 1, 1]:
        raise AssertionError(f'expected one NLM launch per chunk: {runs}')

    # the twin: the same chain with the plain NLM step, on the same rows
    first = torch.from_numpy(x[:DENOISE_CHUNK]).to(DEV)
    y = zheng_detrend(first, DENOISE_FQS, full)
    h = nlm_fused.nlm_bandwidth(y, full.nlm_smooth_factor, full.nlm_patch_halfwidth)
    y2 = y.reshape(-1, DENOISE_LEN)
    twin = nlm_fused.nlm_rows_reference(y2, h.reshape(-1), DENOISE_LEN,
                                        full.nlm_patch_halfwidth).reshape(first.shape)
    raw = zheng_denoise(first, DENOISE_FQS, full)
    ok = torch.ones(first.shape[:2], dtype=torch.bool, device=DEV)
    ok[zero_lead] = False
    twin_err = ((raw[ok] - twin[ok]).abs().max() / y[ok].abs().max()).item()
    chain_err = float(np.abs(outs[0] - np.nan_to_num(raw.cpu().numpy())).max()
                      / np.abs(x[:DENOISE_CHUNK]).max())

    # the chain on the CPU, two records at full search
    cpu = denoise_chunk(x[:2], DENOISE_FQS, full, device='cpu')
    cpu_err = float(np.abs(outs[0][:2] - cpu).max() / np.abs(x[:2]).max())
    zero_ok = bool((outs[0][zero_lead] == 0).all() and torch.isnan(raw[zero_lead]).any())
    finite = all(bool(np.isfinite(o).all()) for o in outs)
    summary = {'phase': 'denoise_check', 'records': int(x.shape[0]),
               'shape': list(x.shape[1:]), 'fqs': DENOISE_FQS,
               'max_abs_err_vs_plain_nlm_twin': twin_err, 'twin_limit': NLM_LIMIT,
               'max_abs_err_chunk_vs_chain': chain_err,
               'max_abs_err_vs_cpu_2_records': cpu_err, 'cpu_limit': DENOISE_CPU_LIMIT,
               'zero_lead_zero': zero_ok, 'finite': finite,
               'by_step_full': _chunk_split(first, full, emit_profiles=True),
               'by_step_128': _chunk_split(first, bounded, emit_profiles=False)}
    emit(summary)
    if not (twin_err <= NLM_LIMIT and chain_err <= NLM_LIMIT
            and cpu_err <= DENOISE_CPU_LIMIT and zero_ok and finite):
        raise AssertionError(f'denoise chain check failed: {summary}')
    second = x[DENOISE_CHUNK:2 * DENOISE_CHUNK]
    for cfg, label in ((bounded, 'search 128'), (full, 'full search')):
        denoise_chunk(second, DENOISE_FQS, cfg, DEV)
        emit(_profile(f'denoise chunk of {DENOISE_CHUNK} records, {label}', 'chunk', 1,
                      lambda: denoise_chunk(second, DENOISE_FQS, cfg, DEV)))
    return {'nlm_rows': launches['nlm_rows']}


def _counts():
    return {'flash_fwd': attn.flash_fwd_kernel.launches,
            'flash_fwd_lse': attn.flash_fwd_lse_kernel.launches,
            'flash_bwd_dq': attn.flash_bwd_dq_kernel.launches,
            'flash_bwd_dkv': attn.flash_bwd_dkv_kernel.launches,
            'adamw': adamw.adamw_kernel.launches,
            'nlm_rows': nlm_fused.nlm_rows_kernel.launches,
            'nlm_variant': probe.variant_kernel.launches}


def _zero_counts():
    for k in (attn.flash_fwd_kernel, attn.flash_fwd_lse_kernel, attn.flash_bwd_dq_kernel,
              attn.flash_bwd_dkv_kernel, adamw.adamw_kernel, nlm_fused.nlm_rows_kernel,
              probe.variant_kernel):
        k.launches = 0


def _steps_per_s(tr: Trainer, data: SplitData, n_steps: int) -> float:
    """Train samples per second over ``n_steps`` steps (host clock, the
    last loss fetched, so the device has finished)."""
    bs = tr.cfg.train_batch_size
    t0 = time.perf_counter()
    for i in range(n_steps):
        m = tr.train_step(data, np.arange(i * bs, (i + 1) * bs) % len(data))
    float(m['loss'])
    return n_steps * bs / (time.perf_counter() - t0)


def profile_train_step(tr: Trainer, data: SplitData, steps: int = 3) -> dict:
    """Where a ViT-base train step spends its time (see ``_profile``)."""
    take = np.arange(tr.cfg.train_batch_size)
    float(tr.train_step(data, take)['loss'])

    def run():
        for _ in range(steps):
            m = tr.train_step(data, take)
        float(m['loss'])
    return _profile(f'ViT-base {tr.model_cfg.dtype} bs-{tr.cfg.train_batch_size} '
                    f'train step, {steps} steps', 'step', steps, run)


def training_phase():
    """ViT-base training through kernels #2-#5 (``flash_min_seq=0`` and a
    blocked-backward threshold of 0, so every layer's forward is the lse
    kernel and its backward the dQ and dK/dV kernels).  Returns the kernel
    launches of the ``Trainer.train()`` run, the main path."""
    attn.BLOCKED_BWD_MIN_SEQ = 0
    stats = PTBXL_TRAIN_STATS['original']
    rng = np.random.default_rng(1)
    n = PARITY_STEPS * 64
    batch = SplitData(
        signals=(0.2 * rng.standard_normal((n, 12, 2500))).astype(np.float32),
        labels=(rng.uniform(size=(n, 71)) < 0.1).astype(np.float32))

    # 1. parity, f32, dropout off: kernels vs a plain twin from one init
    cfg = VitConfig.from_defined('base', flash_min_seq=0, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
    tcfg = TrainConfig(train_batch_size=64, log_to_console=False, save_final=False)
    tr = Trainer(cfg, tcfg, train_data=batch, norm_stats=stats)
    tr.init_state()
    twin = Trainer(dataclasses.replace(cfg, use_flash_attention=False), tcfg,
                   train_data=batch, norm_stats=stats)
    twin.set_params(tr.model.state_dict())
    twin.optimizer.update = adamw.adamw_update_reference
    per_step, losses = [], []
    for k in range(PARITY_STEPS):
        take = np.arange(64 * k, 64 * (k + 1))
        _zero_counts()
        got = float(tr.train_step(batch, take)['loss'])
        counts = _counts()
        _zero_counts()
        want = float(twin.train_step(batch, take)['loss'])
        per_step.append(counts)
        losses.append((got, want))
    layers = cfg.num_hidden_layers
    expect = {'flash_fwd': 0, 'flash_fwd_lse': layers, 'flash_bwd_dq': layers,
              'flash_bwd_dkv': layers, 'adamw': 1, 'nlm_rows': 0, 'nlm_variant': 0}
    param_err = max((a - b).abs().max().item() for a, b in
                    zip(tr.model.state_dict().values(), twin.model.state_dict().values()))
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    f32_rate = _steps_per_s(tr, batch, 5)
    emit({'phase': 'train_parity', 'model': 'ecg-vit-base', 'dtype': 'float32',
          'steps': PARITY_STEPS, 'losses_kernel_plain': losses,
          'max_loss_rel_err': loss_err, 'loss_limit': LOSS_RTOL,
          'max_param_abs_err': param_err, 'param_limit': PARAM_TOL,
          'launches_per_step': per_step, 'expected_per_step': expect,
          'train_samples_per_s_f32': f32_rate})
    if any(c != expect for c in per_step):
        raise AssertionError(f'train steps launched {per_step}, expected {expect} each')
    if not (loss_err <= LOSS_RTOL and param_err <= PARAM_TOL):
        raise AssertionError(f'kernel training differs from the plain twin: losses '
                             f'{losses}, params {param_err}')
    del tr, twin
    torch.cuda.empty_cache()

    # 2. Trainer.train() on the hard corpus, bf16, dropout 0.1, TimeOut
    t0 = time.perf_counter()
    signals, labels, folds = synth_ptbxl(n=TRAIN_N, hard=True, n_marker_classes=16)
    synth_s = time.perf_counter() - t0
    splits = get_ptbxl_splits(signals, labels, folds)
    cfg16 = VitConfig.from_defined('base', flash_min_seq=0, dtype='bfloat16')
    out_dir = 'runs/chip_smoke_train'
    shutil.rmtree(out_dir, ignore_errors=True)
    tr = Trainer(cfg16, TrainConfig(num_train_epoch=2, train_batch_size=64,
                                    augment_timeout=True, log_to_console=False,
                                    save_final=False),
                 train_data=splits.train, eval_data=splits.eval, norm_stats=stats,
                 output_dir=out_dir)
    payloads = []
    log = tr._log
    tr._log = lambda payload: (payloads.append(payload), log(payload))
    _zero_counts()
    t0 = time.perf_counter()
    result = tr.train()
    train_s = time.perf_counter() - t0
    launches = _counts()     # the eval forwards add flash_fwd launches
    shutil.rmtree(out_dir, ignore_errors=True)
    train_losses = [p['train/loss'] for p in payloads if 'train/loss' in p]
    aucs = [h['macro_auc'] for h in result['history']]
    steps = tr.step
    summary = {'phase': 'train', 'model': 'ecg-vit-base', 'dtype': 'bfloat16',
               'corpus': f'synth_ptbxl(n={TRAIN_N}, hard=True, n_marker_classes=16)',
               'corpus_seconds': synth_s, 'train_rows': len(splits.train),
               'eval_rows': len(splits.eval), 'epochs': result['epochs'],
               'steps': steps, 'train_seconds': train_s, 'launches': launches,
               'train_losses': train_losses,
               'eval_losses': [h['loss'] for h in result['history']],
               'eval_macro_auc': aucs,
               'train_samples_per_s_bf16': _steps_per_s(tr, splits.train, 10)}
    emit(summary)
    want = {'flash_fwd_lse': layers * steps, 'flash_bwd_dq': layers * steps,
            'flash_bwd_dkv': layers * steps, 'adamw': steps}
    if not (len(train_losses) == steps == 2 * tr.steps_per_epoch
            and all(np.isfinite(train_losses)) and aucs[-1] is not None
            and np.isfinite(aucs[-1])
            and all(launches[k] == v for k, v in want.items())):
        raise AssertionError(f'training run failed (launches expected {want}): {summary}')
    emit(profile_train_step(tr, splits.train))
    return {k: launches[k] for k in want}


def _post(port: int, payload) -> dict:
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/predict', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# substrings of the port's kernel symbols, for the profiles' ``port_kernels``
PORT_KERNEL_SYMBOLS = ('flash_fwd_', 'bwd_dq_', 'bwd_dkv_', 'adamw_kernel', 'nlm_')


def _profile(what: str, unit: str, n: int, run) -> dict:
    """Profile ``run()``, which does ``n`` units of work ending in a host
    fetch: wall time, summed device time, the device's busy share, the
    kernels that take the most device time, the port's own kernels, and the
    host operators that take the most CPU time of their own (the profiler
    adds to the latter)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _wall(run)
    events = prof.key_averages()
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda k: -k[1])[:10]
    return {'phase': 'profile', 'what': what,
            f'wall_ms_per_{unit}': 1e3 * wall / n,
            f'device_ms_per_{unit}': device_us / 1e3 / n,
            'device_busy_share': device_us / 1e6 / wall,
            f'device_launches_per_{unit}': sum(c for _, _, c in kernels) / n,
            'top_kernels': [{'name': k[:90], f'ms_per_{unit}': t / 1e3 / n,
                             f'launches_per_{unit}': c / n} for k, t, c in top],
            'port_kernels': [{'name': k[:90], f'ms_per_{unit}': t / 1e3 / n,
                              f'launches_per_{unit}': c / n} for k, t, c in kernels
                             if any(sym in k for sym in PORT_KERNEL_SYMBOLS)],
            'top_host_ops': [{'name': k[:60], f'self_cpu_ms_per_{unit}': t / 1e3 / n,
                              f'calls_per_{unit}': c / n} for k, t, c in host]}


def profile_predict(tr: Trainer, batch: np.ndarray, calls: int = 3) -> dict:
    """Where a bs-64 ``predict`` spends its time (see ``_profile``)."""
    tr.predict(batch)
    return _profile(f'bs-64 predict, {calls} calls', 'call', calls,
                    lambda: [tr.predict(batch) for _ in range(calls)])


def _plain_twin(tr: Trainer) -> Trainer:
    """The same weights with attention on the plain path."""
    cfg = dataclasses.replace(tr.model_cfg, use_flash_attention=False)
    twin = Trainer(cfg, tr.cfg, norm_stats={'mean': tr.mean.tolist(),
                                            'std': tr.std.tolist()})
    twin.set_params(tr.model.state_dict())
    return twin


def serving_phase():
    """ViT-base behind the HTTP server; returns (summary, kernel launches)."""
    cfg = VitConfig.from_defined('base', flash_min_seq=0)
    tr = Trainer(cfg, TrainConfig(), norm_stats=PTBXL_TRAIN_STATS['original'])
    tr.init_state()
    rng = np.random.default_rng(0)
    # batch-1 10 s records at 250 Hz, plus one 20 s record that predict_long
    # cuts into 4 windows; raw-scale amplitudes (~0.2 mV)
    inputs = [(0.2 * rng.standard_normal((1, 12, 2500))).astype(np.float32)
              for _ in range(N_CLIENTS - 1)]
    inputs.append((0.2 * rng.standard_normal((1, 12, 5000))).astype(np.float32))

    httpd = serve(tr, port=0)          # warms up with one request
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    got, latency, errors = [None] * N_CLIENTS, [None] * N_CLIENTS, []
    barrier = threading.Barrier(N_CLIENTS)

    def client(i):
        try:
            barrier.wait(timeout=60)
            t0 = time.perf_counter()
            out = _post(port, {'signals': inputs[i].tolist(), 'top_k': 5})
            latency[i] = (time.perf_counter() - t0) * 1e3
            got[i] = np.asarray(out['probs'], np.float32)
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    try:
        batcher = httpd.service.batcher
        d0, r0 = batcher.dispatches, batcher.requests
        attn.flash_fwd_kernel.launches = 0
        clients = [threading.Thread(target=client, args=(i,)) for i in range(N_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        launches = attn.flash_fwd_kernel.launches
        dispatches, requests = batcher.dispatches - d0, batcher.requests - r0
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
        server.join(timeout=60)
    if errors or any(c.is_alive() for c in clients):
        raise RuntimeError(f'serving requests failed: {errors}')
    if requests != N_CLIENTS or launches < cfg.num_hidden_layers * dispatches or launches == 0:
        raise AssertionError(f'{requests} requests, {dispatches} dispatches, '
                             f'{launches} flash launches: the path skipped the kernel')

    plain = _plain_twin(tr)
    err_self = err_plain = 0.0
    for x, probs in zip(inputs, got):
        if probs.shape != (1, cfg.num_class) or not np.isfinite(probs).all():
            raise AssertionError(f'bad response rows: {probs.shape}')
        # the server rounds to 6 decimals; the batch around a row never
        # changes its value, so the row equals its own predict_long
        err_self = max(err_self, float(np.abs(probs - np.round(tr.predict_long(x), 6)).max()))
        err_plain = max(err_plain, float(np.abs(probs - plain.predict_long(x)).max()))
    if err_self > 2e-6 or err_plain > SERVING_TOL:
        raise AssertionError(f'serving rows differ: own input {err_self}, '
                             f'plain attention {err_plain}')

    batch = (0.2 * rng.standard_normal((64, 12, 2500))).astype(np.float32)
    seconds = {'kernel': 0.0, 'plain': 0.0}
    tr.predict(batch)
    plain.predict(batch)
    for name, t in (('kernel', tr), ('plain', plain), ('plain', plain), ('kernel', tr)):
        t0 = time.perf_counter()
        for _ in range(10):
            t.predict(batch)           # returns host arrays: synchronized
        seconds[name] += time.perf_counter() - t0
    rate = {name: 20 * 64 / s for name, s in seconds.items()}
    batch1_ms = 1e3 * min(_wall(lambda: tr.predict(inputs[0])) for _ in range(5))
    body = json.dumps({'signals': inputs[0].tolist()})
    decode_ms = 1e3 * min(_wall(lambda: np.asarray(json.loads(body)['signals'], np.float32))
                          for _ in range(5))

    summary = {'phase': 'serving', 'model': 'ecg-vit-base', 'dtype': 'float32',
               'requests': requests, 'dispatches': dispatches,
               'flash_launches': launches,
               'p50_latency_ms': float(np.median(latency)),
               'max_latency_ms': float(max(latency)),
               'max_abs_err_vs_own_predict_long': err_self,
               'max_abs_err_vs_plain_attention': err_plain, 'limit': SERVING_TOL,
               'bs64_predict_samples_per_s': rate['kernel'],
               'bs64_predict_samples_per_s_plain_attention': rate['plain'],
               'batch1_predict_ms': batch1_ms,
               'request_json_decode_ms': decode_ms}
    emit(summary)
    emit(profile_predict(tr, batch))

    # bf16 Linear layers (--bf16): the kernel against plain attention
    cfg16 = dataclasses.replace(cfg, dtype='bfloat16')
    tr16 = Trainer(cfg16, tr.cfg, norm_stats={'mean': tr.mean.tolist(),
                                              'std': tr.std.tolist()})
    tr16.set_params(tr.model.state_dict())
    want16 = _plain_twin(tr16).predict(batch[:8])
    err16 = float(np.abs(tr16.predict(batch[:8]) - want16).max())
    emit({'phase': 'serving_bf16', 'max_abs_err_vs_plain_attention': err16,
          'limit': BF16_TOL})
    if not err16 <= BF16_TOL:
        raise AssertionError(f'bf16 predict differs from plain attention by {err16}')
    return summary, launches


PHASES = ('kernels', 'serving', 'training', 'denoise')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--phases', nargs='+', choices=PHASES, default=list(PHASES),
                    help='run only these phases (default: all; the result line '
                         'is printed only when all ran)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = ['flash_fwd', 'flash_bwd', 'adamw', 'nlm']
    _build.build(libs)
    build_s = time.perf_counter() - t0
    ptxas = {lib: [ln.strip() for ln in
                   open(f'{_build.library_path(lib)}.log').read().splitlines()
                   if 'Compiling entry' in ln or 'registers' in ln or 'spill' in ln]
             for lib in libs}
    emit({'phase': 'env', 'nvidia_smi': smi, 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'device': torch.cuda.get_device_name(0),
          'kernel_build_s': build_s, 'ptxas': ptxas})

    rows, launches = {}, {}
    if 'kernels' in args.phases:
        rows['flash_fwd'] = kernel_phase()
        dropout_mask_phase()
        bwd_dropout_mask_phase()
        rows.update(flash_grad_phase())
        rows['adamw'] = adamw_phase()
        rows['nlm_rows'] = nlm_phase(*chain_rows())
        rows['nlm_variant'] = nlm_variant_phase()
        launches['nlm_variant'] = rows['nlm_variant']['launches']
    if 'serving' in args.phases:
        _, launches['flash_fwd'] = serving_phase()
    if 'training' in args.phases:
        launches.update(training_phase())
    if 'denoise' in args.phases:
        launches.update(denoise_phase())
    if set(args.phases) != set(PHASES):
        return 0

    print(smi, flush=True)
    emit({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': f'ecg_representation_learning_tpu_torch/ops/csrc/{src}.cu',
        'replaces': replaces, 'launches': launches[name],
        'max_abs_err': rows[name]['max_abs_err'], 'ms': rows[name]['kernel_ms'],
        'plain_ms': rows[name]['plain_ms'], 'bound_ms': rows[name]['bound_ms'],
        'bound_by': rows[name]['bound_by'], 'library_ms': rows[name]['library_ms']}
        for name, src, replaces in KERNELS]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
