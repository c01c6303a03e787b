#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds every CUDA kernel of the serving path from ``ops/csrc`` with nvcc
(into ``build/torch_kernels/``), then:

1. kernel phase: the flash forward kernel against its plain PyTorch version
   on the card (TF32 off), at the serving shape and at longer sequences, in
   f32 and bf16, without and with dropout; its time beside the plain
   version's, a library call's (``scaled_dot_product_attention``, which the
   port never calls) and the least time the card could take;
2. serving phase: ViT-base (f32, 12 layers of attention at 41 tokens, all
   through the kernel: ``flash_min_seq=0``) behind ``serving.serve`` answers
   16 concurrent HTTP requests; every client's rows must equal
   ``predict_long`` of its own input and a forward through plain attention,
   and the kernel's launch count must show the requests went through it;
   then the bs-64 predict throughput with the kernel and with plain
   attention, a profile of that predict, and the check once more with bf16
   Linear layers.

Every phase raises on a failed check.  Prints one JSON object per line; the
line before the last lists the kernels, the last is the result.  Exits
non-zero, printing no result, when no GPU is visible.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig
from ecg_representation_learning_tpu_torch.ops import _build
from ecg_representation_learning_tpu_torch.ops import attention as attn
from ecg_representation_learning_tpu_torch.registry import PTBXL_TRAIN_STATS
from ecg_representation_learning_tpu_torch.serving import serve
from ecg_representation_learning_tpu_torch.train import Trainer

# H100 SXM data sheet: HBM rate, and the dense peak for each input type
# (f32 on the CUDA cores, bf16 on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel vs plain version, max abs error: f32 differs only in summation
# order; bf16 also in where p is rounded (before vs after normalization)
LIMITS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SERVING_SHAPE = (64, 12, 41, 64)     # ViT-base at bs 64: B, H, T = 40 patches + cls, D
KERNEL_CASES = [(SERVING_SHAPE, torch.float32), (SERVING_SHAPE, torch.bfloat16),
                ((2, 12, 1024, 64), torch.bfloat16), ((1, 4, 2049, 64), torch.float32)]
SERVING_TOL = 1e-4                   # probabilities, kernel vs plain attention, f32
BF16_TOL = 2e-2                      # the same in bf16: 8 significant bits
N_CLIENTS = 16


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


def flash_bound(shape, dtype):
    """Least time for one flash forward: q, k, v read once and o written
    once at the HBM rate, against 4*B*H*T^2*D operations (two products) at
    the peak rate for the dtype.  Returns (ms, 'bytes' | 'operations')."""
    b, h, t, d = shape
    elem = torch.finfo(dtype).bits // 8
    bytes_ms = 4 * b * h * t * d * elem / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * b * h * t * t * d / PEAK_OPS_PER_S[dtype] * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


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
                row['kernel_ms'] = time_ms(lambda: attn.flash_attention_forward(q, k, v))
                row['plain_ms'] = time_ms(
                    lambda: attn.flash_attention_forward_reference(q, k, v), reps=20)
                row['library_ms'] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v))
            emit(row)
            rows.append(row)
            if not (row['finite'] and err <= LIMITS[dtype]):
                failures.append(row)
    if failures:
        raise AssertionError(f'flash kernel disagrees with its plain version: {failures}')
    return next(r for r in rows if r['shape'] == list(SERVING_SHAPE)
                and r['dtype'] == str(torch.float32) and r['dropout_rate'] == 0.0)


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


def profile_predict(tr: Trainer, batch: np.ndarray, calls: int = 3) -> dict:
    """Where a bs-64 ``predict`` spends its time: wall time, summed device
    time, the device's busy share and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr.predict(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _wall(lambda: [tr.predict(batch) for _ in range(calls)])
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same device time again
    kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {'phase': 'profile', 'what': f'bs-64 predict, {calls} calls',
            'wall_ms_per_call': 1e3 * wall / calls,
            'device_ms_per_call': device_us / 1e3 / calls,
            'device_busy_share': device_us / 1e6 / wall,
            'top_kernels': [{'name': n[:90], 'ms_per_call': t / 1e3 / calls,
                             'launches_per_call': c / calls} for n, t, c in top]}


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


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build(['flash_fwd'])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             open(f'{_build.library_path("flash_fwd")}.log').read().splitlines()
             if 'registers' in ln or 'spill' in ln]
    emit({'phase': 'env', 'nvidia_smi': smi, 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'device': torch.cuda.get_device_name(0),
          'kernel_build_s': build_s, 'ptxas': ptxas})

    k = kernel_phase()
    _, launches = serving_phase()

    print(smi, flush=True)
    emit({'kernels': [{
        'name': 'flash_fwd', 'route': 'cuda',
        'source': 'ecg_representation_learning_tpu_torch/ops/csrc/flash_fwd.cu',
        'replaces': 'ecg_representation_learning_tpu/ops/attention.py:87',
        'launches': launches, 'max_abs_err': k['max_abs_err'],
        'ms': k['kernel_ms'], 'plain_ms': k['plain_ms'],
        'bound_ms': k['bound_ms'], 'bound_by': k['bound_by'],
        'library_ms': k['library_ms']}]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
