"""Where one Lloyd iteration of the tokenizer's k-means spends its time on the
GPU, at PTB-XL scale.

    python -m ecg_representation_learning_tpu_torch.tools.kmeans_probe [--out x.jsonl]

82,019,772 segments of 8 samples (PTB-XL's 21,837 x 12 x 2500 records, 'shift'
padded to 2504 and cut into 8-sample segments; random values here), 256
centers, 64k-segment chunks, TF32 off.  Times one iteration of each chunk body
and prints a JSON line for each:

  * ``distances``: ``_pairwise_sq_dists`` alone;
  * ``assign``: the distances and their ``min``;
  * ``single_product_bincount``: ``assign``, the (K x chunk) one-hot as one
    product and ``bincount`` counts (two host syncs a chunk);
  * ``port``: the body of ``models.tokenizer.kmeans_fit``: ``assign``, the
    batched one-hot product (``_one_hot_sums``) and integer ``scatter_add_``
    counts (``_count``);

then a ``torch.profiler`` breakdown of ``single_product_bincount`` and of
``port`` (device time by kernel, host time by operator).  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..models import tokenizer as T

N, D, K, CHUNK = 82_019_772, 8, 256, T.DEFAULT_CHUNK


def _iteration(parts, centers, body):
    sums = torch.zeros((K, D), dtype=torch.float64, device=centers.device)
    counts = torch.zeros((K,), dtype=torch.int64, device=centers.device)
    for xb in parts:
        body(xb, centers, sums, counts)


def _assign(xb, centers, sums, counts):
    T._assign(xb, centers)


def _single_product_bincount(xb, centers, sums, counts):
    ids = T._assign(xb, centers)[0]
    onehot = xb.new_zeros((K, xb.shape[0])).scatter_(0, ids[None, :], 1.0)
    with T._no_tf32():
        sums += torch.matmul(onehot, xb)
    counts += torch.bincount(ids, minlength=K)


def _port(xb, centers, sums, counts):
    ids = T._assign(xb, centers)[0]
    sums += T._one_hot_sums(xb, ids, K)
    T._count(counts, ids)


BODIES = {'distances': lambda xb, c, s, n: T._pairwise_sq_dists(xb, c), 'assign': _assign,
          'single_product_bincount': _single_product_bincount, 'port': _port}


def _profile(run) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda r: -r[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])[:12]
    return {'top_kernels_ms': [[k[:80], t, c] for k, t, c in kernels],
            'top_host_ms': [[k[:60], t, c] for k, t, c in host]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=None, help='also append the JSON lines to this file')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('kmeans_probe: no CUDA device visible')
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    x = 0.05 * torch.randn((N, D), generator=gen, device='cuda')
    centers = x[:K].clone()
    parts = torch.split(x, CHUNK)
    lines = [{'device': torch.cuda.get_device_name(0), 'segments': N, 'clusters': K,
              'chunk': CHUNK}]
    for name, body in BODIES.items():
        _iteration(parts, centers, body)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _iteration(parts, centers, body)
        torch.cuda.synchronize()
        lines.append({'variant': name, 'iteration_s': time.perf_counter() - t0})
    for name in ('single_product_bincount', 'port'):
        lines.append({'profile': name, **_profile(
            lambda: _iteration(parts, centers, BODIES[name]))})
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, 'a') as f:
            f.writelines(json.dumps(line) + '\n' for line in lines)


if __name__ == '__main__':
    main()
