"""Serving walkthrough of the PyTorch port (the twin of
``examples/serving_demo.py``): restore or init a model, start the HTTP
server, and show cross-request micro-batching with concurrent clients.

  1. build a model (fresh init here; pass --checkpoint for trained weights,
     a port checkpoint: ``cli train`` output or ``tools/orbax_to_port.py``)
  2. optional weight-only int8 quantization (4x smaller resident weights)
  3. serve() -- resident-model HTTP server with the MicroBatcher
  4. N concurrent batch-1 clients: every client gets its own row; the
     /health counters show the requests were coalesced into fewer device
     dispatches (continuous batching)

Run:  python examples/torch/serving_demo.py [--platform cpu] [--clients 16] [--int8]
(On the GPU by default.)  Expected output (counts vary with scheduling):
  health: ... requests: 17, dispatches: 3-6 ...
  16/16 clients got their own correct row
  coalescing: 17 requests over N dispatches (~4x fewer device calls)
"""
import argparse
import json
import os
import sys
import threading
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np

from ecg_representation_learning_tpu_torch.configs import TrainConfig, VitConfig


def build_trainer(platform=None, checkpoint=None, int8: bool = False,
                  model_cfg: VitConfig = None):
    """Steps 1-2: the served ``Trainer`` (the 'debug' ViT at 320 samples by
    default), restored from ``checkpoint`` and quantized with ``int8``."""
    from ecg_representation_learning_tpu_torch.train import Trainer
    cfg = model_cfg or VitConfig.from_defined('debug', max_signal_length=320)
    tr = Trainer(cfg, TrainConfig(eval_batch_size=32, log_to_console=False), device=platform)
    tr.init_state()
    if checkpoint:
        tr.load_checkpoint(checkpoint)
    if int8:
        print('int8:', tr.enable_int8_inference())
    return tr


def client_signals(n: int, seed: int = 0) -> np.ndarray:
    """The ``n`` clients' records, (n, 12, 250): one each."""
    return np.random.default_rng(seed).standard_normal((n, 12, 250)).astype(np.float32)


def run_clients(tr, n: int, max_wait_ms: float = 50.0, seed: int = 0):
    """Steps 3-4: serve ``tr`` on a free local port and send ``n``
    concurrent batch-1 requests.  Returns (each client's probabilities,
    ``tr.predict`` of each client's own record, the /health counters)."""
    from ecg_representation_learning_tpu_torch.serving import serve
    httpd = serve(tr, port=0, warmup=True, max_wait_ms=max_wait_ms)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f'serving on 127.0.0.1:{port}')
    sigs = client_signals(n, seed)
    got = [None] * n

    def client(i):
        body = json.dumps({'signals': sigs[i].tolist(), 'top_k': 3}).encode()
        req = urllib.request.Request(f'http://127.0.0.1:{port}/predict', data=body,
                                     headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        got[i] = np.asarray(out['probs'])[0]
        if i == 0:
            print('client 0 top codes:', [t['code'] for t in out['top'][0]])

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        health = json.loads(urllib.request.urlopen(f'http://127.0.0.1:{port}/health',
                                                   timeout=30).read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
    want = [tr.predict(sigs[i:i + 1])[0] for i in range(n)]   # each record alone
    return got, want, health


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--platform', default=None, choices=['cuda', 'cpu'])
    ap.add_argument('--clients', type=int, default=16)
    ap.add_argument('--checkpoint', default=None,
                    help='port checkpoint from `cli train` (fresh init if unset)')
    ap.add_argument('--int8', action='store_true')
    ap.add_argument('--max-wait-ms', type=float, default=50.0,
                    help='micro-batching collection deadline (0 = coalesce '
                         'only while a dispatch is in flight)')
    args = ap.parse_args(argv)
    tr = build_trainer(args.platform, args.checkpoint, args.int8)
    got, want, h = run_clients(tr, args.clients, args.max_wait_ms)
    n = args.clients
    ok = sum(np.allclose(got[i], np.round(want[i], 6), atol=2e-6) for i in range(n))
    print('health:', h)
    print(f'{ok}/{n} clients got their own correct row')
    print(f"coalescing: {h['requests']} requests over {h['dispatches']} "
          f"dispatches (~{h['requests'] / max(h['dispatches'], 1):.1f}x "
          f'fewer device calls)')
    assert ok == n


if __name__ == '__main__':
    main()
