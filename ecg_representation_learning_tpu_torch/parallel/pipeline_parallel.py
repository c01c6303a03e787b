"""GPipe pipeline parallelism over a 'stage' mesh axis (the JAX package's
``parallel/pipeline_parallel.py``).

A homogeneous block stack (the ViT's ``ScannedBlocks``: parameters stacked
(L, ...)) is split over the ranks of the 'stage' axis:

  * layer l lives on stage l // (L / S): ``stack_stage_params`` reshapes the
    stacks to (S, L / S, ...) and ``place_stage_params`` keeps this rank's
    (L / S, ...) slice, so a rank holds only its own layers;
  * ``pipeline_apply`` runs the GPipe schedule, M microbatches in M + S - 1
    steps.  Every stage runs every step: stage 0 takes microbatch t (the
    last one again once t >= M), the others the activation handed over by
    ``spmd.ppermute`` at the step before; the bubbles compute on garbage,
    masked at the output, so their cotangents are zero.  The last stage's
    outputs are broadcast over the axis (``spmd.sum_over``: the sum forward,
    the identity backward);
  * the backward is autograd's: every rank runs the inverse ``ppermute``s
    of the same steps in reverse order.  For that, every rank's graph
    reaches every hop, as JAX's one program does: the input selection and
    the output mask are ``torch.where``s whose untaken side gets a zero
    cotangent, never a branch that drops a hop from the graph;
  * with a dropout seed, every (pipeline step, stage, layer) draws from its
    own ``DropoutRng``, seeded from (seed, the rank's index on every other
    mesh axis, step * S + stage, layer) -- the JAX ``fold_in`` chain, with
    the port's generators -- so data ranks draw decorrelated masks.

``pipeline_apply`` takes this rank's microbatches (on a ('data', 'stage')
mesh, its data rows of each: the JAX ``x_spec=P(None, 'data')``) and returns
their outputs on every stage.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.dropout import DropoutRng
from . import spmd
from .mesh import STAGE_AXIS


def stack_stage_params(stacked_params: Mapping[str, torch.Tensor],
                       n_stage: int) -> Dict[str, torch.Tensor]:
    """(L, ...)-stacked block parameters -> (S, L / S, ...)."""
    out = {}
    for name, a in stacked_params.items():
        if a.shape[0] % n_stage:
            raise ValueError(f'{name}: {a.shape[0]} layers do not split into {n_stage} stages')
        out[name] = a.reshape(n_stage, a.shape[0] // n_stage, *a.shape[1:])
    return out


def place_stage_params(stage_params: Mapping[str, torch.Tensor], mesh,
                       axis: str = STAGE_AXIS) -> Dict[str, torch.Tensor]:
    """This rank's (L / S, ...) slice of (S, L / S, ...) stage stacks, on its
    device: each rank holds only its own layers."""
    sid = spmd.axis_index(axis, mesh)[0]
    return {k: a[sid].to(mesh.device).contiguous() for k, a in stage_params.items()}


def layer_rng(seed: int, path, device) -> DropoutRng:
    """The ``DropoutRng`` of one stream: host and device generators seeded
    from ``SeedSequence([seed, *path])``."""
    state = np.random.SeedSequence([int(seed), *[int(p) for p in path]]).generate_state(
        2, np.uint64)
    host = torch.Generator().manual_seed(int(state[0] >> 2))
    dev = torch.Generator(device=device)
    dev.manual_seed(int(state[1] >> 2))
    return DropoutRng(host=host, device=dev)


def pipeline_apply(stage_params: Mapping[str, torch.Tensor], x_micro: torch.Tensor,
                   block_fn: Callable, mesh, axis: str = STAGE_AXIS,
                   rng: Optional[int] = None) -> torch.Tensor:
    """Pipelined forward of this rank's (M, ...) microbatches over axis
    ``axis`` of ``mesh``.

    ``stage_params``: this rank's layers, {name: (L / S, ...)}.
    ``block_fn(layer_params, activation) -> activation`` applies one block
    ({name: (...)} of one layer); with ``rng`` (a seed, the same on every
    rank) it is ``block_fn(layer_params, activation, layer_rng)`` with the
    ``DropoutRng`` of its (pipeline step, stage, layer).  Returns the (M, ...)
    outputs on every rank of the axis.  Differentiable; every rank of the
    axis must call it (the backward, too, is a collective)."""
    sid, n_stage = spmd.axis_index(axis, mesh)
    m = x_micro.shape[0]
    n_steps = m + n_stage - 1
    n_local = next(iter(stage_params.values())).shape[0]
    others = [mesh.index(name) for name in mesh.shape if name != axis] if rng is not None else []
    first = torch.tensor(sid == 0, device=x_micro.device)
    last = torch.tensor(sid == n_stage - 1, device=x_micro.device)

    def apply_stage(act, t):
        for i in range(n_local):
            lp = {k: v[i] for k, v in stage_params.items()}
            if rng is None:
                act = block_fn(lp, act)
            else:   # one stream per (pipeline step, stage, layer)
                act = block_fn(lp, act, layer_rng(rng, [*others, t * n_stage + sid, i],
                                                  x_micro.device))
        return act

    act_in = torch.zeros_like(x_micro[0])
    done = []
    for t in range(n_steps):
        # stage 0 injects microbatch t (garbage once t >= m: masked below)
        act = torch.where(first, x_micro[min(t, m - 1)], act_in)
        act = apply_stage(act, t)
        if t >= n_stage - 1:           # the last stage finished microbatch t - S + 1
            done.append(act)
        if t < n_steps - 1:            # hand the activation to the next stage
            act_in = spmd.ppermute(act, axis, 1, mesh)
    out = torch.where(last, torch.stack(done).to(x_micro.dtype), torch.zeros_like(x_micro))
    return spmd.sum_over(out, axis, mesh)   # only the last stage's are real: broadcast them
