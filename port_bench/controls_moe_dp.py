"""Readings that the limits of the MoE cell's and the data-parallel cell's
checks are set from, on the card at the cells' own sizes (the benchmark's
runs do not run this).

    python3 port_bench/controls_moe_dp.py --workload moonlight_ep8_cls_k4 --program 101-106 --control 201-203
    python3 port_bench/controls_moe_dp.py --workload vitb_cls_dp4 --control 201-203

Each ``--program`` seed (the MoE cell) runs the cell's set-up and the check's
steps through the program (no window) and the reference's run of them: the
lower readings; the data-parallel cell's program readings are its runs on
four cards.  Each ``--control`` seed runs the reference again in the
program's place, on one card: in float8 (the control, one precision below
the configuration's bf16) and with half of each batch (of each data rank's
rows) left out of the loss (a planted fault); the data-parallel cell's also
with the gradient exchange left out (rank 0 stepping on its own rows' loss
alone, a second planted fault); a step that returns its state
unchanged reads 1 by ``delta_gap`` and needs no run.  One JSON line per
reading.
"""
from __future__ import annotations

import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from port_bench import checks, harness, inputs  # noqa: E402
from port_bench.controls import make_run, seeds  # noqa: E402
from port_bench.drivers import train, train_dp, train_moe  # noqa: E402


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--program', default=None)
    p.add_argument('--control', default=None)
    args = p.parse_args()
    entry = harness.resolve(args.workload)[0]
    moe = harness.resolve(args.workload)[3]['driver'] == 'train_moe'
    for seed in (seeds(args.program) if args.program and moe else []):
        r = make_run(args.workload, seed)
        st, prog, rows, chosen = train_moe.setup(r)
        total = st['tr'].total_steps
        idx = torch.as_tensor(rows, device=r.device)
        sig, lab = st['sig'][idx].clone(), st['lab'][idx].clone()
        del st
        free()
        base, ref_chosen = train_moe.follow(r, sig, lab, len(prog['losses']), total, 'f32')
        print(json.dumps({'workload': args.workload, 'seed': seed, 'side': 'program',
                          **train_moe.numbers(prog, base, chosen, ref_chosen, r.config)}),
              flush=True)
        free()
    for seed in (seeds(args.control) if args.control else []):
        r = make_run(args.workload, seed)
        rows = train.check_rows(r)
        sig, lab = inputs.ptbxl_split(r.traffic['train_records'], r.config['num_channels'],
                                      r.config['record_samples'], r.config['num_class'], seed,
                                      r.device)
        idx = torch.as_tensor(rows, device=r.device)
        sig, lab = sig[idx].clone(), lab[idx].clone()
        free()
        steps = len(rows) // r.traffic['batch_size']
        total = (r.traffic['train_records'] // r.traffic['batch_size']) * r.traffic['epochs']
        if moe:
            base, chosen = train_moe.follow(r, sig, lab, steps, total, 'f32')
            for side, (reading, ch) in (
                    ('control_fp8', train_moe.follow(r, sig, lab, steps, total, 'fp8')),
                    ('fault_half_batch', train_moe.follow(r, sig, lab, steps, total, 'f32',
                                                          True))):
                print(json.dumps({'workload': args.workload, 'seed': seed, 'side': side,
                                  **train_moe.numbers(reading, base, ch, chosen, r.config)}),
                      flush=True)
        else:
            ranks = entry['chips']
            base = train_dp.follow(r, sig, lab, steps, total, 'f32', ranks)
            for side, reading in (
                    ('control_fp8', train_dp.follow(r, sig, lab, steps, total, 'fp8', ranks)),
                    ('fault_half_batch', train_dp.follow(r, sig, lab, steps, total, 'f32',
                                                         ranks, True)),
                    ('fault_no_exchange', train_dp.follow(r, sig, lab, steps, total, 'f32',
                                                          ranks, exchange=False))):
                print(json.dumps({'workload': args.workload, 'seed': seed, 'side': side,
                                  **checks.gaps(reading, base)}), flush=True)
        free()
    return 0


if __name__ == '__main__':
    sys.exit(main())
