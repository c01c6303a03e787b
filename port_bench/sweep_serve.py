"""Find the serving knee: offer rising rates of a serving cell's traffic to one
server and see where the tail and the backlog start to grow.

    python3 port_bench/sweep_serve.py --workload vitb_serve_poisson --seed 5 \
        --seconds 30 --rates 25,30,35,40,45,50

The server (the cell's configuration at ``serve``'s defaults) is built once;
each rate runs the load generator for ``--seconds``.  One JSON line per rate:
requests, failures, p50 and p95 (ms), the p95 of the first and the last
third of the schedule, and how long after the schedule's end the last answer
came (the backlog).  The last line names the knee: the highest rate whose
last third's p95 is at most twice its first third's and whose backlog
drains within half a second.  The cell runs at about four fifths of it.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import harness  # noqa: E402
from port_bench.drivers import serve  # noqa: E402


def point(res: dict, rate: float, seconds: float) -> dict:
    due, end = np.asarray(res['due']), np.asarray(res['end'])
    ok = np.asarray(res['status']) == 200
    lat = np.where(ok, end - due, np.inf)
    thirds = np.array_split(lat, 3)
    return {'rate': rate, 'requests': int(lat.size), 'failed': int((~ok).sum()),
            'p50_ms': float(1e3 * np.median(lat)), 'p95_ms': float(1e3 * np.percentile(lat, 95)),
            'p95_first_third_ms': float(1e3 * np.percentile(thirds[0], 95)),
            'p95_last_third_ms': float(1e3 * np.percentile(thirds[-1], 95)),
            'backlog_s': float(np.nanmax(end) - seconds),
            'late_p95_ms': float(1e3 * np.percentile(res['late'], 95))}


def main() -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, default=5)
    p.add_argument('--seconds', type=float, default=12.0)
    p.add_argument('--rates', required=True)
    args = p.parse_args()
    r = harness.Run(workload=args.workload, seed=args.seed, seconds=args.seconds, trace=False,
                    device=torch.device('cuda', 0), t_process=time.perf_counter())
    _, r.cell, r.config, r.traffic = harness.resolve(args.workload)
    tr, httpd, thread = serve.start_server(r, r.config, r.traffic)
    knee = None
    try:
        for rate in (float(v) for v in args.rates.split(',')):
            proc = serve.loadgen(r, httpd.server_address[1], rate, args.seconds)
            proc.stdin.write('go\n')
            proc.stdin.flush()
            row = point(serve.finish(proc, args.seconds + 180.0), rate, args.seconds)
            print(json.dumps(row), flush=True)
            if (row['failed'] == 0 and row['backlog_s'] < 0.5
                    and row['p95_last_third_ms'] <= 2.0 * row['p95_first_third_ms']):
                knee = rate
    finally:
        serve.stop_server(httpd, thread)
    print(json.dumps({'knee_rate': knee, 'cell_rate': None if knee is None else 0.8 * knee,
                      'device': torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
