"""The numbers that decide ``correct`` for the training cells, and the plain
reference's run of the same steps.

A training cell's check compares, between the program and the reference
that followed its first steps from the same weights, rows, seed and
schedule:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad1_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - b1), by the worst leaf: the gap between the
  two norms of the leaf over the reference's norm of the leaf or of the
  median leaf, whichever is larger;
* ``delta_gap``: the same for each leaf's change after the last step
  followed, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from .reference import model as ref

ROUNDOFF_SHARE = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[k].detach().float().norm() for k in names]) * scale
    return dict(zip(names, norms.tolist()))


def _worst(prog: Dict[str, float], base: Dict[str, float], names: Sequence[str]) -> float:
    med = float(torch.tensor([base[k] for k in names]).median())
    return max(abs(prog[k] - base[k]) / max(base[k], med, 1e-30) for k in names)


def gaps(prog: dict, base: dict) -> Dict[str, float]:
    """The three numbers of ``prog``'s readings against ``base``'s; each
    reading is {'losses': [...], 'grad1': {leaf: norm}, 'delta': {leaf:
    norm}}."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog['losses'], base['losses']))
    if len(prog['losses']) != len(base['losses']):
        loss = float('inf')
    names = list(base['grad1'])
    med = float(torch.tensor([base['grad1'][k] for k in names]).median())
    moved = [k for k in names if base['grad1'][k] >= ROUNDOFF_SHARE * med]
    return {'loss_gap': loss, 'grad1_gap': _worst(prog['grad1'], base['grad1'], names),
            'delta_gap': _worst(prog['delta'], base['delta'], moved)}


def judged(numbers: Dict[str, float], limits: Dict[str, float]):
    """(name, number, limit) of each number the cell compares; the others
    (a cell's limits name only numbers that separate the program from its
    control) are printed for the record."""
    import sys
    for name, v in numbers.items():
        if name not in limits:
            print(f'not compared: {name} {v!r}', file=sys.stderr)
    return [(name, v, limits[name]) for name, v in numbers.items() if name in limits]


def follow(w0: Dict[str, torch.Tensor], batches: List[Callable[[], tuple]], loss_fn,
           train: dict, total_steps: int, seed: int, device, mode: str = 'f32',
           half: bool = False) -> dict:
    """The reference's run of ``len(batches)`` optimizer steps from ``w0``:
    each batch is a callable giving ``(inputs, targets)``, ``loss_fn(p, x,
    y, draws, mode, half)`` the mean loss of a batch.  ``half`` plants a fault:
    each step's loss is the mean over the first half of the batch alone.
    Returns the readings ``gaps`` compares."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in w0.items()}
    opt = ref.AdamW(p, train, total_steps)
    draws = ref.Draws(seed, device)
    losses, grad1 = [], None
    for s, make in enumerate(batches):
        x, y = make()
        loss = loss_fn(p, x, y, draws, mode, half)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        opt.step(p, grads)
        losses.append(float(loss.detach()))
        if s == 0:
            grad1 = leaf_norms(opt.mu, 1.0 / (1.0 - train['b1']))
        del grads, loss
    delta = leaf_norms({k: p[k].detach() - w0[k].float() for k in p})
    return {'losses': losses, 'grad1': grad1, 'delta': delta}


def time_end_pad(x: torch.Tensor, patch: int) -> torch.Tensor:
    """Zero-pad the time axis at the end to the next multiple of ``patch``;
    an aligned length gains a whole patch, as the configurations' input
    transform does (2500 -> 2560)."""
    return torch.nn.functional.pad(x, (0, patch - x.shape[-1] % patch))
