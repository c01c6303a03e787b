"""Driver of the serving cells: the port's HTTP server (``serving.serve`` at
its defaults, a ``Trainer`` holding the seed's weights) in this process, and
the open-loop load generator (``loadgen.py``) in a process of its own.

Set-up builds the trainer and the server (whose warm-up runs one request)
and starts the generator, which encodes its bodies and sends a few requests
of each kind; the window opens when it is told to go.  The served
probabilities of a sample of the window's requests are compared, after the
window has closed and the server is down, with the plain reference's
z-norm, pad, forward and sigmoid of the same records (for a long record the
windows and their maximum).
"""
from __future__ import annotations

import gc
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .. import checks, inputs, records
from ..reference import model as ref
from ..trace import Trace
from .train import vit_config

TRACE_S = 2.0
TRACE_TAIL_S = 2.0     # load after the traced slice, so a dispatch comes to end it
LATE_GRACE_S = 60.0   # how long past the schedule's end a request may still answer


def start_server(r, cfg: dict, traffic: dict):
    """(trainer, server, its thread) for ``cfg`` on the run's device."""
    from ecg_representation_learning_tpu_torch.configs import TrainConfig
    from ecg_representation_learning_tpu_torch.serving import serve
    from ecg_representation_learning_tpu_torch.train import Trainer
    tr = Trainer(vit_config(cfg), TrainConfig(eval_batch_size=traffic['eval_batch_size'],
                                              log_to_console=False, seed=r.seed),
                 norm_stats=cfg['norm_stats'], output_dir=r.scratch('run'), device=r.device)
    tr.set_params(inputs.weights(ref.vit_shapes(cfg), r.seed, r.device))
    httpd = serve(tr, host='127.0.0.1', port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return tr, httpd, thread


def stop_server(httpd, thread) -> None:
    httpd.shutdown()
    thread.join()
    httpd.server_close()
    httpd.service.close()


def loadgen(r, port: int, rate: float, seconds: float) -> subprocess.Popen:
    """The generator process, once it has said it is ready."""
    import json
    traffic_path = os.path.join(r.scratch(), 'traffic.json')
    with open(traffic_path, 'w') as f:
        json.dump(r.traffic, f)
    cmd = [sys.executable, os.path.join(os.path.dirname(os.path.dirname(__file__)), 'loadgen.py'),
           '--port', str(port), '--traffic', traffic_path, '--seed', str(r.seed),
           '--rate', repr(rate), '--seconds', repr(seconds),
           '--leads', str(r.config['num_channels']), '--classes', str(r.config['num_class']),
           '--sample', str(r.traffic['check_sample'])]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if line.strip() != 'ready':
        proc.kill()
        proc.wait()
        raise RuntimeError(f'the load generator did not start: {line!r}')
    return proc


def finish(proc: subprocess.Popen, timeout: float) -> dict:
    import json
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f'the load generator exited with {proc.returncode}')
    return json.loads(out.strip().splitlines()[-1])


def latencies(res: dict, seconds: float) -> np.ndarray:
    """Latency (s) of every request due inside the window, from its due time
    to its answer; a failed request's is infinite."""
    due, end = np.asarray(res['due']), np.asarray(res['end'])
    ok = np.asarray(res['status']) == 200
    lat = np.where(ok, end - due, np.inf)
    return lat[due < seconds]


def run(r) -> None:
    cfg, traffic, dev = r.config, r.traffic, r.device
    rate = float(traffic['rate_per_s'])
    tr, httpd, thread = start_server(r, cfg, traffic)
    calls = {'calls': 0, 'rows': 0, 'call_s': 0.0}
    slice_ = {'want': 'warm', 'trace': None, 'first': 0, 'started': threading.Event()}
    if r.trace:
        inner = tr.predict_long

        def counted(signals, *a, **kw):
            """The served runner's calls: requests a dispatch, host time a
            dispatch; and the traced slice, started and stopped in the
            dispatcher's thread (the profiler records the device work of the
            thread it starts in) at the first dispatch after the main thread
            asks.  The generator's warm-up requests start and stop one
            profile first, so the slice's start costs no set-up of its own."""
            want = slice_['want']
            if want == 'warm':
                Trace(dev).start().stop(digest=False)
                slice_['want'] = None
            elif want == 'start' and slice_['trace'] is None:
                slice_['trace'], slice_['first'] = Trace(dev).start(), calls['calls']
                slice_['started'].set()
            elif want == 'stop' and slice_['trace'] is not None and not r.tr:
                slice_['trace'].stop()
                slice_['trace'].units = calls['calls'] - slice_['first']
                r.tr = slice_['trace']
            t = time.perf_counter()
            try:
                return inner(signals, *a, **kw)
            finally:
                calls['calls'] += 1
                calls['rows'] += len(signals)
                calls['call_s'] += time.perf_counter() - t
        tr.predict_long = counted
    span = r.seconds + (TRACE_S + TRACE_TAIL_S if r.trace else 0.0)
    proc = loadgen(r, httpd.server_address[1], rate, span)
    try:
        t0 = r.start_window()
        proc.stdin.write('go\n')
        proc.stdin.flush()
        if r.trace:
            time.sleep(max(0.0, t0 + r.seconds - time.perf_counter()))
            slice_['want'] = 'start'
            if slice_['started'].wait(TRACE_S + TRACE_TAIL_S):
                time.sleep(TRACE_S)
            slice_['want'] = 'stop'
        res = finish(proc, span + LATE_GRACE_S + 60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stop_server(httpd, thread)
    if r.trace and not r.tr:
        print('serve: no dispatch came to end the traced slice', file=sys.stderr)
    lat = latencies(res, r.seconds)
    r.attempted = int(lat.size)
    r.failed = int(np.isinf(lat).sum())
    r.e2e['serve_p95_ms'] = float(1e3 * np.percentile(lat, 95))
    late = np.asarray(res['late'])
    r.serve = {**calls, 'late_p95_ms': float(1e3 * np.percentile(late, 95)),
               'late_max_ms': float(1e3 * late.max()), 'p50_ms': float(1e3 * np.median(lat))}
    print(f'serve: {lat.size} requests in the window, p50 {r.serve["p50_ms"]:.3f} ms, '
          f'generator late p95 {r.serve["late_p95_ms"]:.3f} ms, '
          f'max {r.serve["late_max_ms"]:.3f} ms', file=sys.stderr)
    if str(dev).startswith('cuda'):
        r.memory_peak = torch.cuda.max_memory_allocated(dev)
    del tr
    gc.collect()
    if str(dev).startswith('cuda'):
        torch.cuda.empty_cache()

    sched = records.schedule(traffic, r.seed, rate, span)
    sample = records.check_sample(sched, traffic['check_sample'], r.seed)
    served = {int(i): np.asarray(v) for i, v in res['answers'].items()}
    want = reference_probs(r, sched, sample, 'f32')
    got_all = [i for i in sample if i in served]
    gap = max((float(np.abs(served[i] - want[i]).max()) for i in got_all), default=float('inf'))
    r.checks = [('prob_gap', gap, r.cell['limits']['prob_gap']),
                ('sample_unanswered', float(len(sample) - len(got_all)), 0.0),
                ('malformed', float(res['malformed']), 0.0)]


def reference_probs(r, sched: dict, sample, mode: str) -> dict:
    """The reference's probabilities of the requests ``sample``: the records
    as the server parses them (float32), z-normalized, padded to a patch
    multiple (a whole patch where aligned), forward in eval mode, sigmoid; a
    record longer than the model's input in windows of the input less one
    patch, half a window apart (the last ending at the record's end), the
    maximum over its windows."""
    cfg, dev = r.config, r.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pools = records.pools(r.traffic, cfg['num_channels'], r.seed)
    p = inputs.weights(ref.vit_shapes(cfg), r.seed, dev)
    mean = torch.tensor(cfg['norm_stats']['mean'], device=dev).reshape(-1, 1)
    std = torch.tensor(cfg['norm_stats']['std'], device=dev).reshape(-1, 1)
    win = cfg['max_signal_length'] - cfg['patch_size']
    out = {}
    with torch.no_grad():
        for i in sample:
            rec = pools['long' if sched['long'][i] else 'rest'][sched['record'][i]]
            x = torch.as_tensor(rec.astype(np.float32), device=dev)
            x = (x - mean) / std
            length = x.shape[-1]
            if length < cfg['max_signal_length']:
                parts = x[None]
            else:
                starts = list(range(0, length - win + 1, win // 2))
                if starts[-1] + win < length:
                    starts.append(length - win)
                parts = torch.stack([x[:, s:s + win] for s in starts])
            logits = ref.vit_logits(p, checks.time_end_pad(parts, cfg['patch_size']), cfg,
                                    None, mode)
            out[int(i)] = torch.sigmoid(logits).amax(dim=0).cpu().double().numpy()
    return out
