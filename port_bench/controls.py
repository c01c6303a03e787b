"""Readings that the limits of a cell's check are set from, on the card at
the cell's own size (the benchmark's runs do not run this).

    python3 port_bench/controls.py --workload vitb_cls_k4 --program 101-112 --control 201-203

For a training cell, each ``--program`` seed runs the cell's set-up and the
check's steps through the program (no window) and the reference's run of
them: the lower readings.  Each ``--control`` seed runs the reference twice
more in the program's place: in float8 (the control, one precision below the
configuration's bf16) and with half of each batch left out of the loss (a
planted fault); a step that returns its state unchanged reads 1 by
``delta_gap`` and needs no run.  For the serving cell each ``--control``
seed compares the reference's float8 probabilities of the check's sample
with its float32 ones (the served program's readings are the cell's runs).
One JSON line per reading.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import checks, harness, inputs, records  # noqa: E402
from port_bench.drivers import mae_stream, serve, train  # noqa: E402


def seeds(spec: str):
    lo, _, hi = spec.partition('-')
    return range(int(lo), int(hi or lo) + 1)


def make_run(workload: str, seed: int) -> harness.Run:
    r = harness.Run(workload=workload, seed=seed, seconds=0.0, trace=False,
                    device=torch.device('cuda', 0), t_process=time.perf_counter())
    _, r.cell, r.config, r.traffic = harness.resolve(workload)
    return r


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def training(workload: str, program, control) -> None:
    r0 = make_run(workload, 0)
    mae = r0.traffic['driver'] == 'mae_stream'
    for seed in program:
        r = make_run(workload, seed)
        if mae:
            st, prog, paths = mae_stream.setup(r)
            total = st['tr'].total_steps
            del st
            free()
            base = mae_stream.follow(r, paths, total, 'f32')
        else:
            st, prog, rows = train.setup(r)
            total = st['tr'].total_steps
            idx = torch.as_tensor(rows, device=r.device)
            sig, lab = st['sig'][idx].clone(), st['lab'][idx].clone()
            del st
            free()
            base = train.follow(r, sig, lab, len(prog['losses']), total, 'f32')
        print(json.dumps({'workload': workload, 'seed': seed, 'side': 'program',
                          **checks.gaps(prog, base)}), flush=True)
        free()
    for seed in control:
        r = make_run(workload, seed)
        if mae:
            paths = inputs.write_shards(r.scratch('shards'), r.traffic['corpora'],
                                        r.config['num_channels'],
                                        float(r.traffic['wire_scale']), seed, r.device)
            total = r.traffic['stream_steps']

            def run_ref(mode, half=False):
                return mae_stream.follow(r, paths, total, mode, half)
        else:
            rows = train.check_rows(r)
            sig, lab = inputs.ptbxl_split(r.traffic['train_records'], r.config['num_channels'],
                                          r.config['record_samples'], r.config['num_class'],
                                          seed, r.device)
            idx = torch.as_tensor(rows, device=r.device)
            sig, lab = sig[idx].clone(), lab[idx].clone()
            free()
            steps = len(rows) // r.traffic['batch_size']
            total = (r.traffic['train_records'] // r.traffic['batch_size']) * r.traffic['epochs']

            def run_ref(mode, half=False):
                return train.follow(r, sig, lab, steps, total, mode, half)
        base = run_ref('f32')
        for side, reading in (('control_fp8', run_ref('fp8')),
                              ('fault_half_batch', run_ref('f32', half=True))):
            print(json.dumps({'workload': workload, 'seed': seed, 'side': side,
                              **checks.gaps(reading, base)}), flush=True)
        free()


def serving(workload: str, control) -> None:
    for seed in control:
        r = make_run(workload, seed)
        rate = float(r.traffic['rate_per_s'])
        sched = records.schedule(r.traffic, seed, rate, 20.0)
        sample = records.check_sample(sched, r.traffic['check_sample'], seed)
        base = serve.reference_probs(r, sched, sample, 'f32')
        low = serve.reference_probs(r, sched, sample, 'fp8')
        gap = max(float(np.abs(low[i] - base[i]).max()) for i in sample)
        print(json.dumps({'workload': workload, 'seed': seed, 'side': 'control_fp8',
                          'prob_gap': gap}), flush=True)
        free()


def main() -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--program', default=None)
    p.add_argument('--control', default=None)
    args = p.parse_args()
    program = seeds(args.program) if args.program else []
    control = seeds(args.control) if args.control else []
    if harness.resolve(args.workload)[3]['driver'] == 'serve':
        serving(args.workload, control)
    else:
        training(args.workload, program, control)
    return 0


if __name__ == '__main__':
    sys.exit(main())
