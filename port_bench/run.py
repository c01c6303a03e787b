"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload vitb_cls_k4 --seed 1 --seconds 20 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (read from the same window and a profiled slice after it).
The last line of standard output is one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error.  The
run needs the CUDA devices its cell asks for and exits non-zero without a
result otherwise.  Build and kernel caches stay in fixed directories inside
the checkout.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the moment this process started."""
    now = time.perf_counter()
    try:
        with open('/proc/self/stat') as f:
            start_ticks = int(f.read().rpartition(')')[2].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (('TRITON_CACHE_DIR', 'triton'), ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('CUDA_CACHE_PATH', 'cuda')):
    os.environ[_var] = os.path.join(ROOT, 'port_bench', '.cache', _sub)

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from port_bench import harness
    entry, _, _, _ = harness.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry['chips']:
        print(f'port_bench: {args.workload} needs {entry["chips"]} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    run = harness.Run(workload=args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device('cuda', 0),
                      t_process=T_PROCESS)
    out = harness.execute(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f'port_bench: the run loaded {", ".join(bad)}', file=sys.stderr)
        return 3
    for name, c in out['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
