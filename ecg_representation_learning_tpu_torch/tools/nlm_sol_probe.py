"""Speed-of-light attribution probe for the fused NLM kernel, on the GPU.

    python -m ecg_representation_learning_tpu_torch.tools.nlm_sol_probe

Counterpart of the JAX package's ``tools/nlm_sol_probe.py``.  Times the
kernel of ``ops/csrc/nlm.cu`` and structurally identical variants with one
component switched off (the ``nlm_variant`` entry of the same source), then
differences the times.  The components map to lines of the kernel:

  boxtree  -- the (2*pw+1)-tap Darbon window (else the SSD at the position)
  exp      -- the weight transcendental (else w = d / h)
  mirror   -- the -s direction
  accum    -- the masked accumulation of both directions (else every step
              adds the unmasked weight)

The variants are the template switches of the same design as ``nlm_rows``
(replacing the JAX probe's ``_variant_kernel``): a row's shifts split over a
thread block cluster, at pw = 10 and rows of up to 4096 11 weights per
thread and shift in registers with an add-only box sum, the -s term from
a shared weight row behind one barrier per shift.  So ``full - (-mirror)``
is what that shared-row term costs, and ``full - (-exp)`` what the accurate
exp costs.  Every variant also normalizes with 1e-12, not the f64 epsilon,
as the TPU probe does.  Each has a plain PyTorch version
(``variant_reference``), which the CPU tests hold to the JAX probe's
kernel.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.nlm_fused import nlm_rows_kernel, nlm_rows_reference
from ..runtime import default_device

SHAPE = (768, 2500, 128, 10)   # rows (64 records x 12 leads), L, search, patch half-width
VARIANTS = (
    ('full', {}),
    ('-mirror', {'mirror': False}),
    ('-exp', {'exp': False}),
    ('-boxtree', {'boxtree': False}),
    ('-accum(mirror too)', {'accum': False}),
)
EPS = 1e-12
REPS = 10


def variant_reference(x2: torch.Tensor, h2: torch.Tensor, sch_wd: int, patch_wd: int,
                      flags: Dict[str, bool]) -> torch.Tensor:
    """Plain PyTorch version of one variant."""
    return nlm_rows_reference(x2, h2, sch_wd, patch_wd, eps=EPS, **flags)


def run_variant(x2: torch.Tensor, h2: torch.Tensor, sch_wd: int, patch_wd: int,
                flags: Dict[str, bool]) -> torch.Tensor:
    """One variant: a kernel launch for CUDA tensors, the plain version for
    CPU tensors."""
    dev = x2.device.type
    if dev == 'cuda':
        return nlm_rows_kernel(x2.contiguous(), (1.0 / h2).contiguous(), sch_wd, patch_wd,
                               dict(flags))
    if dev == 'cpu':
        return variant_reference(x2, h2, sch_wd, patch_wd, flags)
    raise RuntimeError(f'no nlm variant for device {x2.device}')


def measure() -> Dict[str, float]:
    """Device ms of each variant at ``SHAPE`` on the GPU, over REPS calls on
    two seeded N(0, 1) inputs in turn, h = 1 (CUDA events, after two warm-up
    calls).  Raises when no GPU is visible."""
    dev = default_device()
    r, n, sch, pw = SHAPE
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((r, n)).astype(np.float32)).to(dev)
          for _ in range(2)]
    h = torch.ones(r, device=dev)
    times = {}
    for name, flags in VARIANTS:
        for i in range(2):
            run_variant(xs[i], h, sch, pw, flags)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(REPS):
            run_variant(xs[i % 2], h, sch, pw, flags)
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / REPS
    return times


def attribution(times: Dict[str, float]) -> Dict[str, float]:
    """Component ms = full - the variant without it."""
    return {name[1:]: times['full'] - t for name, t in times.items() if name != 'full'}


def main() -> None:
    times = measure()
    for name, ms in times.items():
        print(f'{name:22s}: {ms:7.2f} ms')
    full = times['full']
    print('\nattribution (component = full - variant-without-it):')
    for name, ms in attribution(times).items():
        print(f'  {name:20s}: {ms:6.2f} ms ({100 * ms / full:4.1f}%)')
    r, n, sch, _ = SHAPE
    print(f'\nper-pair element volume: {r * n:,} elems x {sch} pairs '
          f'= {r * n * sch / 1e9:.2f} G elem-visits')
    print(f'full kernel: {r * n * sch / (full * 1e-3) / 1e12:.3f} T elem-visits/s')
    print(f'device: {torch.cuda.get_device_name(0)}')


if __name__ == '__main__':
    main()
