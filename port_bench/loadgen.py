"""The serving cell's load generator, in a process of its own (its own
interpreter lock): an open loop of batch-1 JSON ``POST /predict`` requests
on the seeded schedule of ``records.schedule``.

    python3 port_bench/loadgen.py --port P --traffic port_bench/traffic/X.json \
        --seed S --rate R --seconds T --leads 12 --classes 71 --sample 48

It encodes every pool record's body first, sends a few requests of each kind
in turn (warm-up), prints ``ready`` and waits for a line on standard input.
Then a scheduler thread hands each request to a pool of sender threads at
its due time; a request's latency runs from its due time to the end of its
response, so a stall delays the requests behind it.  When every request has
ended (each may take up to ``--timeout`` seconds) it prints one JSON line:
per request its due, start and end times (s from the start), its HTTP
status (-1 for a connection error), the scheduler's lateness, and the
probabilities the server returned for the requests of ``check_sample``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import http.client
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import records  # noqa: E402


def post(port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        conn.request('POST', '/predict', body=body,
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main() -> int:
    p = argparse.ArgumentParser()
    for flag in ('--port', '--seed', '--leads', '--classes', '--sample'):
        p.add_argument(flag, type=int, required=True)
    p.add_argument('--traffic', required=True)
    p.add_argument('--rate', type=float, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--timeout', type=float, default=120.0)
    args = p.parse_args()
    with open(args.traffic) as f:
        traffic = json.load(f)
    bodies = records.bodies(traffic, args.leads, args.seed)
    sched = records.schedule(traffic, args.seed, args.rate, args.seconds)
    sample = set(records.check_sample(sched, args.sample, args.seed).tolist())
    n = len(sched['due'])

    for kind in ('rest', 'long'):                 # warm-up, one at a time
        for body in bodies[kind][:2]:
            status, _ = post(args.port, body, args.timeout)
            if status != 200:
                print(f'loadgen: warm-up request answered {status}', file=sys.stderr)
                return 1
    print('ready', flush=True)
    if not sys.stdin.readline():
        return 1

    start, end = np.full(n, np.nan), np.full(n, np.nan)
    status = np.zeros(n, np.int64)
    late = np.zeros(n)
    answers = {}
    malformed = [0]
    lock = threading.Lock()

    def send(i: int, t0: float) -> None:
        kind = 'long' if sched['long'][i] else 'rest'
        start[i] = time.perf_counter() - t0
        try:
            code, data = post(args.port, bodies[kind][sched['record'][i]], args.timeout)
        except OSError:
            code, data = -1, b''
        end[i] = time.perf_counter() - t0
        status[i] = code
        if code == 200:
            try:
                probs = json.loads(data)['probs'][0]
                ok = len(probs) == args.classes
            except (ValueError, KeyError, IndexError, TypeError):
                ok = False
            if not ok:
                with lock:
                    malformed[0] += 1
            elif i in sample:
                answers[i] = probs

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=traffic['workers'])
    t0 = time.perf_counter()
    futures = []
    for i, due in enumerate(sched['due']):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - t0 - due
        futures.append(pool.submit(send, i, t0))
    for fut in futures:
        fut.result()
    pool.shutdown()
    print(json.dumps({'due': sched['due'].tolist(), 'long': sched['long'].tolist(),
                      'start': start.tolist(), 'end': end.tolist(),
                      'status': status.tolist(), 'late': late.tolist(),
                      'malformed': malformed[0],
                      'answers': {str(i): v for i, v in answers.items()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
