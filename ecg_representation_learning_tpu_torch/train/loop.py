"""Train-step mechanics: gradient accumulation, the compute copies of the
cast leaves and the shared update tail.

Counterpart of the JAX package's ``train/loop.py``.  ``grad_accum`` runs the
microbatches one after another (JAX scans them), collecting each leaf's
gradient over them; ``finish_update`` is the update tail -- the mean over
the microbatches, global norm and the device-side non-finite counter, the
optimizer step (for ``FusedAdamW`` all of it in one fused step), the
parameter EMA.

A layer that computes in bf16 from f32 parameters (a ``vit.Dense`` with
``dtype='bfloat16'``, a ``moe.HeldExperts`` stack) casts them at call time
(:func:`cast_leaves`).  While a trainer keeps ``ComputeCopies``, each such
leaf has a bf16 copy that lives across steps: kernel #5 writes it from the
updated parameter in its update pass, a training forward reads it in place
of the parameter (``torch.func.functional_call``'s substitution, so the
layer's cast is a no-op), and autograd differentiates it, so the leaf's
gradient arrives in bf16, one tensor per microbatch, which ``grad_accum``
keeps apart and #5 reads -- no cast of the weight each microbatch, no cast
of its gradient back to f32, no f32 sum of the microbatches and no
division: #5 makes (f32(g_1) + ... + f32(g_n)) / n as it reads them, the f32
operations in autograd's order, the same bits.  ``count_param_casts``
counts the casts a training forward on the card still makes.

On a mesh (``parallel.mesh.ShardedModel``) the microbatches but the last run
their backward without averaging gradients over 'data' (DDP's ``no_sync``,
FSDP2's ``set_requires_gradient_sync(False)``), the gradients are the local
shards, the update tail takes the mesh-wide norm (``ops.adamw.NormReduce``)
and the EMA is laid out like the params (each rank updates its shards).
DDP's and FSDP2's hooks sit on the f32 parameters, so only a step of the step
tape on a mesh of 'data' alone, which averages the gradients itself
(``ShardedModel.sync_grads``), reads the copies there.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils.stateless import _reparametrize_module

from ..ops import _build
from ..ops.adamw import NormReduce, mean_grads, mesh_norm_reference
from ..utils import tracing
from .optim import AdamChain, FusedAdamW, FusedAdamWState, global_norm

# a leaf's gradient over a step's microbatches: one f32 tensor (autograd's
# sum), or its compute copy's bf16 gradient of each microbatch
Grad = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class StepGrads(NamedTuple):
    """A step's gradients as ``grad_accum`` returns them: each leaf's
    ``Grad`` by name, summed over ``accum`` microbatches and not yet divided
    (``finish_update`` takes the mean)."""
    leaves: Dict[str, Grad]
    accum: int


def _casts(m: nn.Module) -> Optional[Tuple[Tuple[str, ...], Optional[torch.dtype]]]:
    """For a layer that casts parameters to its compute dtype at call time,
    ``(their names, that dtype or None for its input's)``: ``vit.Dense``
    (weight and bias; not the weight while it computes with an int8 one),
    ``moe.HeldExperts`` (its stacks, to its input's dtype), the Switch
    ``moe.MoeMlp`` (its stacks but the int8 ones, and its biases); else
    None."""
    from ..models.moe import HeldExperts, MoeMlp
    from ..models.vit import Dense
    if isinstance(m, Dense):
        return ('weight', 'bias') if m.int8 is None else ('bias',), m.compute_dtype
    if isinstance(m, HeldExperts):
        return ('gate_up', 'down'), None
    if isinstance(m, MoeMlp):
        return tuple(n for n in ('w1', 'b1', 'w2', 'b2') if n not in m.int8), m.compute_dtype
    return None


def cast_leaves(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The f32 parameters of ``model`` that a layer casts to bf16 at call
    time and that can have a compute copy, by name: those of a bf16
    ``Dense`` that holds no int8 weight and no Megatron slice, and the
    stacks of a bf16 DeepSeek MoE layer's ``HeldExperts`` (not the leaves of
    a ``ScannedBlocks``, whose template computes, nor the Switch layer's)."""
    from ..models.moe import DeepseekMoe, MoeMlp
    from ..models.vit import ScannedBlocks
    held = {id(m.experts) for m in model.modules()
            if isinstance(m, DeepseekMoe) and m.compute_dtype == torch.bfloat16}
    stacked = {id(m) for s in model.modules() if isinstance(s, ScannedBlocks)
               for m in s.modules()}
    out = {}
    for prefix, m in model.named_modules():
        casts = _casts(m)
        if (casts is None or id(m) in stacked or isinstance(m, MoeMlp)
                or getattr(m, 'int8', None) is not None or getattr(m, 'tp', None) is not None
                or not (casts[1] == torch.bfloat16 or id(m) in held)):
            continue
        for attr in casts[0]:
            p = m._parameters.get(attr)
            if p is not None and p.dtype == torch.float32:
                out[f'{prefix}.{attr}' if prefix else attr] = p
    return out


def count_param_casts(model: nn.Module) -> None:
    """Count, as ``param_cast`` in ``ops/_build``'s launch registry, each
    parameter cast that a training forward of one of ``model``'s layers
    (a ``ScannedBlocks``' template's included) makes on the card: a forward
    pre-hook on each layer that casts.  0 where the layers read the compute
    copies."""
    from ..models.vit import ScannedBlocks

    def hook(m, args):
        if m.training:
            names, dt = _casts(m)
            dt = dt or args[0].dtype
            n = sum(1 for name in names
                    if (t := getattr(m, name)) is not None and t.is_cuda and t.dtype != dt)
            if n:
                _build.add_launches({'param_cast': n})
    templates = [s.template for s in model.modules() if isinstance(s, ScannedBlocks)]
    for m in [*model.modules(), *(m for t in templates for m in t.modules())]:
        if _casts(m) is not None:
            m.register_forward_pre_hook(hook)


class ComputeCopies:
    """The bf16 compute copies of ``model``'s :func:`cast_leaves`:
    ``copies[name]``, a bf16 leaf tensor that requires grad, held outside
    the module's parameters (``state_dict`` and checkpoints do not see it).
    Kernel #5 writes it from the updated parameter at every step
    (``finish_update``); ``write`` writes every copy from its parameter
    where the trainer changed the parameters otherwise (its
    ``_reset_optimizer``: init, ``set_params``, a checkpoint).
    ``reading()`` is the context of a training microbatch whose forward
    reads the copies in place of the parameters; ``take_grads()`` returns
    that microbatch's gradients of the copies and takes them off.  A layer
    reads its copy once a forward: two reads would sum their gradients in
    bf16 before #5 sees them."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.copies: Dict[str, torch.Tensor] = {}
        self.write()

    @torch.no_grad()
    def write(self) -> None:
        """Every copy written from its parameter, allocated anew where the
        parameter's shape or device changed."""
        for name, p in cast_leaves(self.model).items():
            c = self.copies.get(name)
            if c is None or c.shape != p.shape or c.device != p.device:
                c = self.copies[name] = torch.empty_like(p, dtype=torch.bfloat16)
                c.requires_grad_(True)
            c.copy_(p)

    def reading(self):
        """The model's forward reads the copies for the duration."""
        return _reparametrize_module(self.model, self.copies)

    def take_grads(self) -> Dict[str, torch.Tensor]:
        """Each copy's gradient of the microbatch just back-propagated (zeros
        for a copy no forward read), taken off the copy."""
        out = {}
        for name, c in self.copies.items():
            out[name] = torch.zeros_like(c) if c.grad is None else c.grad
            c.grad = None
        return out


def grad_accum(micro_fn: Callable[[torch.Tensor], Tuple[Any, torch.Tensor]],
               params: Dict[str, torch.Tensor], idx: torch.Tensor,
               accum: int, sharded=None, marks=tracing.NO_MARKS,
               copies: Optional[ComputeCopies] = None) -> Tuple[List[Any], StepGrads]:
    """Run ``micro_fn(idx_k) -> (aux, loss)`` over ``accum`` equal slices of
    ``idx`` (the JAX ``idx.reshape(accum, -1)``), back-propagating each loss,
    and return ``([aux_k], StepGrads)``: per leaf the f32 sum of its
    microbatch gradients (autograd's), or with ``copies`` (a
    ``ComputeCopies``, read by the microbatches' forwards) for a copied leaf
    the tuple of its copy's bf16 gradients, one a microbatch; with their
    count, so the update tail takes the mean (``finish_update``), which
    equals the full-batch gradient mean.  Activation memory is one
    microbatch's.  ``sharded`` (a ``ShardedModel``): gradients are synced
    over 'data' after the last microbatch only, and the local shards are
    returned.  ``marks`` (``utils.tracing.StepMarks``): a mark after each
    microbatch's loss ('forward') and gradients ('backward', the last one
    after the sync)."""
    for p in params.values():
        p.grad = None
    parts: Dict[str, List[torch.Tensor]] = {}
    aux = []
    for k, idx_k in enumerate(idx.reshape(accum, -1)):
        with contextlib.ExitStack() as ctx:
            if sharded is not None:
                ctx.enter_context(sharded.no_sync(k == accum - 1))
            if copies is not None:
                ctx.enter_context(copies.reading())
            with tracing.span('step.forward'):
                a, loss = micro_fn(idx_k)
            marks.mark('forward')
            with tracing.span('step.backward'):
                loss.backward()
            if k < accum - 1:
                marks.mark('backward')
        if copies is not None:
            for name, g in copies.take_grads().items():
                parts.setdefault(name, []).append(g)
        aux.append(a)
    grads: Dict[str, Grad] = {}
    for name, p in params.items():
        if name not in parts:
            grads[name] = p.grad
        elif p.grad is not None:
            raise RuntimeError(f'{name} was read both through its compute copy and as the '
                               'parameter in one step')
        else:
            grads[name] = tuple(parts[name])
    if sharded is not None:
        grads = sharded.sync_grads(grads)
    marks.mark('backward')
    return aux, StepGrads(grads, accum)


def finish_update(optimizer: Union[FusedAdamW, AdamChain], cfg, opt_state: FusedAdamWState,
                  params: Dict[str, torch.Tensor], grads: Union[StepGrads, Dict[str, torch.Tensor]],
                  nonfinite_count: torch.Tensor, ema: Dict[str, torch.Tensor] = None,
                  reduce: Optional[NormReduce] = None, scalars: Optional[torch.Tensor] = None,
                  copies: Optional[ComputeCopies] = None
                  ) -> Tuple[FusedAdamWState, torch.Tensor, torch.Tensor]:
    """The update tail on the mean gradient: ``grads`` as ``grad_accum``
    returns them (``StepGrads``), or each leaf's mean gradient.  Returns
    ``(opt_state, grad_norm, nonfinite_count)``; ``params`` (and ``ema``
    when ``cfg.ema_decay > 0``) change in place, and with ``copies`` (only
    for ``FusedAdamW``) the compute copies with them.

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
    grads, accum = grads if isinstance(grads, StepGrads) else (grads, 1)
    if isinstance(optimizer, FusedAdamW):
        opt_state, grad_norm, nonfinite_count = optimizer.step(
            grads, opt_state, params, nonfinite_count, reduce=reduce,
            lr_bc=None if scalars is None else scalars[:3], accum=accum,
            copies=None if copies is None else copies.copies)
    else:
        grads = dict(zip(grads, mean_grads(list(grads.values()), accum)))
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
