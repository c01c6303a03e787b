"""Readings that the limits of the long-record cells' checks are set from, on
the card at the cells' own sizes (the benchmark's runs do not run this).

    python3 port_bench/controls_long.py --workload trinity_ep16_t8k_k4 --program 101-112 --control 201-203
    python3 port_bench/controls_long.py --workload vitb_long_mae_t2048 --program 101-112 --control 201-203

Every seed runs the cell's set-up and the check's steps through the program
(no window) and the reference's run of them (f32): a ``program`` line, the
lower readings.  Each ``--control`` seed also runs the reference in the
program's place in float8 (the control, one precision below the
configuration's bf16) and with half of each step's records left out of the
loss (a planted fault): ``control_fp8`` and ``fault_half_batch`` lines
against the f32 run.  A step that returns its state unchanged reads 1 by
``delta_gap`` and needs no run.  One JSON line per reading.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from port_bench import checks  # noqa: E402
from port_bench.controls import free, make_run, seeds  # noqa: E402
from port_bench.drivers import long_mim, train_afmoe  # noqa: E402


def afmoe(r, control: bool) -> None:
    st, prog, rows, chosen = train_afmoe.setup(r)
    total = st['tr'].total_steps
    idx = torch.as_tensor(rows, device=r.device)
    sig, lab = st['sig'][idx].clone(), st['lab'][idx].clone()
    del st
    free()
    steps = len(prog['losses'])
    base, ref_chosen = train_afmoe.follow(r, sig, lab, steps, total, 'f32')
    emit(r, 'program', train_afmoe.numbers(prog, base, chosen, ref_chosen, r.config))
    if control:
        for side, (reading, ch) in (
                ('control_fp8', train_afmoe.follow(r, sig, lab, steps, total, 'fp8')),
                ('fault_half_batch', train_afmoe.follow(r, sig, lab, steps, total, 'f32', True))):
            emit(r, side, train_afmoe.numbers(reading, base, ch, ref_chosen, r.config))


def mim(r, control: bool) -> None:
    st, prog, rows, masks = long_mim.setup(r)
    st['group'].close()
    total = st['total']
    sig = st['sig'][torch.as_tensor(rows, device=r.device)].clone()
    del st
    free()
    base = long_mim.follow(r, sig, masks, total, 'f32')
    emit(r, 'program', checks.gaps(prog, base))
    if control:
        for side, reading in (('control_fp8', long_mim.follow(r, sig, masks, total, 'fp8')),
                              ('fault_half_batch', long_mim.follow(r, sig, masks, total, 'f32',
                                                                   True))):
            emit(r, side, checks.gaps(reading, base))


def emit(r, side: str, numbers: dict) -> None:
    print(json.dumps({'workload': r.workload, 'seed': r.seed, 'side': side, **numbers}),
          flush=True)


def main() -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--program', default=None)
    p.add_argument('--control', default=None)
    args = p.parse_args()
    run = {'train_afmoe': afmoe, 'long_mim': mim}[make_run(args.workload, 0).traffic['driver']]
    program = list(seeds(args.program)) if args.program else []
    control = list(seeds(args.control)) if args.control else []
    for seed in program + control:
        run(make_run(args.workload, seed), seed in control)
        free()
    return 0


if __name__ == '__main__':
    sys.exit(main())
