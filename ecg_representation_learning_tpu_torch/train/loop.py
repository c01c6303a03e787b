"""Train-step mechanics: gradient accumulation and the shared update tail.

Counterpart of the JAX package's ``train/loop.py``.  ``grad_accum`` runs the
microbatches one after another (JAX scans them), summing their gradients in
the parameters' ``.grad`` and taking the mean; ``finish_update`` is the
update tail -- global norm and the device-side non-finite counter, the
optimizer step (for ``FusedAdamW`` all three in one fused step), the
parameter EMA.

On a mesh (``parallel.mesh.ShardedModel``) the microbatches but the last run
their backward without averaging gradients over 'data' (DDP's ``no_sync``,
FSDP2's ``set_requires_gradient_sync(False)``), the gradients are the local
shards, the update tail takes the mesh-wide norm (``ops.adamw.NormReduce``)
and the EMA is laid out like the params (each rank updates its shards).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.adamw import NormReduce, mesh_norm_reference
from ..utils import tracing
from .optim import AdamChain, FusedAdamW, FusedAdamWState, global_norm


def grad_accum(micro_fn: Callable[[torch.Tensor], Tuple[Any, torch.Tensor]],
               params: Dict[str, torch.Tensor], idx: torch.Tensor,
               accum: int, sharded=None, marks=tracing.NO_MARKS
               ) -> Tuple[List[Any], Dict[str, torch.Tensor]]:
    """Run ``micro_fn(idx_k) -> (aux, loss)`` over ``accum`` equal slices of
    ``idx`` (the JAX ``idx.reshape(accum, -1)``), back-propagating each loss,
    and return ``([aux_k], mean grads)``.  Activation memory is one
    microbatch's; the mean of the microbatch gradient means equals the
    full-batch gradient mean.  ``sharded`` (a ``ShardedModel``): gradients
    are synced over 'data' after the last microbatch only, and the local
    shards are returned.  ``marks`` (``utils.tracing.StepMarks``): a mark
    after each microbatch's loss ('forward') and gradients ('backward', the
    last one after the sync and the mean)."""
    for p in params.values():
        p.grad = None
    aux = []
    for k, idx_k in enumerate(idx.reshape(accum, -1)):
        with contextlib.nullcontext() if sharded is None else sharded.no_sync(k == accum - 1):
            with tracing.span('step.forward'):
                a, loss = micro_fn(idx_k)
            marks.mark('forward')
            with tracing.span('step.backward'):
                loss.backward()
            if k < accum - 1:
                marks.mark('backward')
        aux.append(a)
    if sharded is not None:
        sharded.sync_grads()
        grads = sharded.grads()
    else:
        grads = {k: p.grad for k, p in params.items()}
    if accum > 1:
        torch._foreach_div_(list(grads.values()), float(accum))
    marks.mark('backward')
    return aux, grads


def finish_update(optimizer: Union[FusedAdamW, AdamChain], cfg, opt_state: FusedAdamWState,
                  params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  nonfinite_count: torch.Tensor, ema: Dict[str, torch.Tensor] = None,
                  reduce: Optional[NormReduce] = None, scalars: Optional[torch.Tensor] = None
                  ) -> Tuple[FusedAdamWState, torch.Tensor, torch.Tensor]:
    """The update tail.  Returns ``(opt_state, grad_norm, nonfinite_count)``;
    ``params`` (and ``ema`` when ``cfg.ema_decay > 0``) change in place.

    A non-finite global gradient norm adds one to ``nonfinite_count`` on the
    device (the host raises at its next sync), and with ``cfg.debug_nans``
    that step's gradients are zeroed by select, so the parameters are never
    poisoned: inside the fused step (``FusedAdamW.step``: norm, scalars,
    counter and update, on the GPU two kernel launches), or here before the
    optax chain (whose clip then sees a norm of 0, the norm of the zeroed
    gradients).  ``reduce`` (on a mesh): the norm is the mesh-wide one, so
    every rank clips by it and zeroes the same steps.  ``scalars``: the
    step's [lr, bc1, bc2, -lr] as 4 f32 on the device (a step tape's row,
    ``train/dispatch.py``), which the optimizers read in place of the values
    they would make from the count."""
    if isinstance(optimizer, FusedAdamW):
        opt_state, grad_norm, nonfinite_count = optimizer.step(
            grads, opt_state, params, nonfinite_count, reduce=reduce,
            lr_bc=None if scalars is None else scalars[:3])
    else:
        grad_norm = (global_norm(list(grads.values())) if reduce is None
                     else mesh_norm_reference([grads[k] for k in params], reduce))
        finite = torch.isfinite(grad_norm)
        nonfinite_count = nonfinite_count + (~finite).to(torch.int32)
        clip_norm = grad_norm
        if cfg.debug_nans:
            with torch.no_grad():
                grads = {k: torch.where(finite, g, torch.zeros((), dtype=g.dtype,
                                                               device=g.device))
                         for k, g in grads.items()}
            clip_norm = torch.where(finite, grad_norm, 0.0)
        opt_state = optimizer.apply(grads, opt_state, params, g_norm=clip_norm,
                                    scalars=None if scalars is None else scalars[1:])
    if cfg.ema_decay > 0:   # e * d + p * (1 - d), d and 1 - d in f32 as in JAX
        d = np.float32(cfg.ema_decay)
        e, p = list(ema.values()), [params[k] for k in ema]
        with torch.no_grad():
            torch._foreach_mul_(e, float(d))
            torch._foreach_add_(e, torch._foreach_mul(p, float(np.float32(1) - d)))
    return opt_state, grad_norm, nonfinite_count
