"""The fused AdamW step, the optax chain and the learning-rate schedules.

Counterpart of the JAX package's ``train/optim.py``: ``FusedAdamW`` with its
exact semantics, ``AdamChain`` (the optax chain of ``fused_optimizer=False``,
in plain PyTorch: XLA in JAX, so it has no kernel), ``make_schedule``
(optax's warmup-cosine, cosine, linear warmup + constant, computed in f32 as
optax does) and ``make_optimizer``.

``FusedAdamW.step`` (and ``apply``) runs ``ops/adamw.adamw_tail``: the
global gradient norm, the clip and non-finite select folded into the scalars
``[scale, lr, bc1, bc2, finite]`` on the device, the non-finite counter and
the update of every leaf in place -- on the GPU two kernel launches of
``ops/csrc/adamw.cu`` and one pinned copy of [lr, bc1, bc2] and the
gradients' addresses.  Nothing in a step waits for the device.  A step run
from a tape (``train/dispatch.py``) hands both optimizers its scalars as a
device row instead, so a CUDA graph of the step reads each step's values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import TrainConfig
from ..ops.adamw import NormReduce, adamw_tail, global_norm
from ..utils.check_args import ca

Schedule = Callable[[int], float]
_F32 = np.float32


@dataclasses.dataclass
class FusedAdamWState:
    """Mirrors the JAX ``FusedAdamWState(count, mu, nu)``: ``mu`` and ``nu``
    map each parameter name to its moment; ``count`` counts the steps taken
    (a host int: the schedule reads it without a device sync)."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class FusedAdamW:
    """Adam/AdamW + global-norm clip + non-finite zeroing in one pass.

    Exact optax semantics, as the JAX ``FusedAdamW``: bias correction uses
    the post-increment count, the schedule the pre-increment count, weight
    decay is added to the Adam term before the lr scaling, clipping scales
    by min(1, clip / max(||g||, 1e-16)), and a zeroed (non-finite) step still
    decays the moments.  ``mu_dtype`` stores the first moment in that dtype.
    """

    def __init__(self, learning_rate: Union[float, Schedule], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None, zero_nonfinite: bool = False,
                 mu_dtype: Optional[Union[str, torch.dtype]] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.zero_nonfinite = zero_nonfinite
        if isinstance(mu_dtype, str):
            mu_dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[mu_dtype]
        self.mu_dtype = mu_dtype
        # the tail; ops.adamw.adamw_tail_reference runs the plain version on
        # any device (chip_smoke.py's twin uses it on the card)
        self.tail = adamw_tail

    def init(self, params: Dict[str, torch.Tensor]) -> FusedAdamWState:
        return FusedAdamWState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(_F32(lr(count) if callable(lr) else lr))

    def lr_bc(self, count: int) -> Tuple[float, float, float]:
        """(lr, bc1, bc2) in f32 for the step that takes the count from
        ``count`` to ``count + 1``."""
        c = _F32(count + 1)
        return (self.lr_at(count), float(_F32(1) - _F32(self.b1) ** c),
                float(_F32(1) - _F32(self.b2) ** c))

    def step(self, grads: Dict[str, torch.Tensor], state: FusedAdamWState,
             params: Dict[str, torch.Tensor], nonfinite_count: Optional[torch.Tensor] = None,
             g_norm: Optional[torch.Tensor] = None, reduce: Optional[NormReduce] = None,
             lr_bc: Optional[torch.Tensor] = None, accum: int = 1,
             copies: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[FusedAdamWState, torch.Tensor, Optional[torch.Tensor]]:
        """One step from the gradients: updates ``params`` and the moments in
        place and returns ``(state with its count advanced, grad_norm,
        nonfinite_count + !isfinite(grad_norm))``.  ``g_norm`` may be passed
        when the caller has it already; ``reduce`` (on a mesh, with the
        leaves in ``params``' order) makes the norm the mesh-wide one;
        ``lr_bc``, 3 f32 on the device, replaces ``self.lr_bc(state.count)``
        (a step tape's row, which holds those values).  ``grads`` and
        ``accum``: each leaf's mean gradient, an f32 sum or a tuple of bf16
        microbatch gradients over ``accum``; ``copies``: the bf16 compute
        copies to write from the updated parameters, by name
        (``ops/adamw.py``)."""
        names = list(params)
        grad_norm, nonfinite_count = self.tail(
            [params[k] for k in names], [grads[k] for k in names],
            [state.mu[k] for k in names], [state.nu[k] for k in names],
            self.lr_bc(state.count) if lr_bc is None else lr_bc, nonfinite_count,
            clip_norm=self.clip_norm,
            zero_nonfinite=self.zero_nonfinite, b1=self.b1, b2=self.b2, eps=self.eps,
            wd=self.weight_decay, g_norm=g_norm, accum=accum,
            copies=None if copies is None else [copies.get(k) for k in names],
            **({} if reduce is None else {'reduce': reduce}))
        return dataclasses.replace(state, count=state.count + 1), grad_norm, nonfinite_count

    def apply(self, grads: Dict[str, torch.Tensor], state: FusedAdamWState,
              params: Dict[str, torch.Tensor],
              g_norm: Optional[torch.Tensor] = None) -> FusedAdamWState:
        """One step: updates ``params`` and the moments in place and returns
        the state with its count advanced.  ``g_norm`` may be passed when the
        caller has it already."""
        return self.step(grads, state, params, g_norm=g_norm)[0]


class AdamChain:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr, weight_decay,
    mu_dtype=mu_dtype))`` (``adam`` when weight_decay is 0), leaf by leaf in
    plain PyTorch with optax's operations in optax's order:

        g   = ||g|| < clip ? g : (g / ||g||) * clip
        mu  = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g*g + b2 * nu
                                        (b1 rounded to mu's dtype)
        u   = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
        p   = p + (-lr) * u

    with bc = 1 - b**count after the increment and lr from the schedule at the
    count before it.  ``trainable`` (a set of parameter names; None: all),
    set by ``pretrain.make_probe_optimizer``, zeroes the updates of every
    other parameter after the chain, as ``optax.masked(optax.set_to_zero(),
    frozen)``: their moments still move, the clip still sees their
    gradients, and their values are left untouched.
    Non-finite steps are zeroed by the caller (``loop.finish_update``), as in
    JAX.  The state is the fused path's ``FusedAdamWState``."""

    def __init__(self, learning_rate: Union[float, Schedule], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None,
                 mu_dtype: Optional[Union[str, torch.dtype]] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        if isinstance(mu_dtype, str):
            mu_dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[mu_dtype]
        self.mu_dtype = mu_dtype
        self.trainable: Optional[frozenset] = None

    init = FusedAdamW.init
    lr_at = FusedAdamW.lr_at
    lr_bc = FusedAdamW.lr_bc

    def apply(self, grads: Dict[str, torch.Tensor], state: FusedAdamWState,
              params: Dict[str, torch.Tensor],
              g_norm: Optional[torch.Tensor] = None,
              scalars: Optional[torch.Tensor] = None) -> FusedAdamWState:
        """One step: updates ``params`` and the moments in place and returns
        the state with its count advanced.  ``scalars``: [bc1, bc2, -lr] as
        3 f32 on the device (a step tape's row), else made here from the
        count."""
        names = list(params)
        if g_norm is None:
            g_norm = global_norm([grads[k] for k in names])
        if scalars is None:
            c = _F32(state.count + 1)
            scalars = torch.tensor([_F32(1) - _F32(self.b1) ** c, _F32(1) - _F32(self.b2) ** c,
                                    -self.lr_at(state.count)], dtype=torch.float32)
        bc1, bc2, neg_lr = scalars.to(g_norm.device).unbind(0)
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            for k in names:
                p, mu, nu = params[k], state.mu[k], state.nu[k]
                g = grads[k].float()
                if self.clip_norm is not None:
                    g = torch.where(g_norm < self.clip_norm, g, (g / g_norm) * self.clip_norm)
                # optax's weak-typed b1 takes mu's dtype (bf16: 0.8984375); XLA
                # then keeps the product in f32 up to the add
                b1_mu = float(torch.tensor(b1, dtype=mu.dtype))
                mu2 = (1 - b1) * g + b1_mu * mu.float()
                nu2 = (1 - b2) * (g * g) + b2 * nu
                u = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + self.eps)
                if self.weight_decay:
                    u = u + self.weight_decay * p
                mu.copy_(mu2)
                nu.copy_(nu2)
                if self.trainable is None or k in self.trainable:
                    p.add_(neg_lr * u)
        return dataclasses.replace(state, count=state.count + 1)


def adam_moments(opt_state: FusedAdamWState
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(mu, nu) of either optimizer's state: ``FusedAdamW`` and ``AdamChain``
    both keep a ``FusedAdamWState`` (the JAX ``adam_moments`` also reads the
    optax chain's tuple, a layout the port does not have)."""
    return opt_state.mu, opt_state.nu


def _polynomial(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (polynomial with power 1), in f32."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1), in f32."""
    if not decay_steps > 0:
        raise ValueError(f'cosine decay needs positive decay_steps, got {decay_steps}')

    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cos = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        return float(_F32(init) * ((_F32(1) - _F32(alpha)) * cos + _F32(alpha)))
    return schedule


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    """optax.join_schedules: each later schedule counts from its boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def make_schedule(cfg: TrainConfig, total_steps: int) -> Schedule:
    """The learning rate at each optimizer step (0-based), optax's values."""
    ca(schedule=cfg.schedule)
    lr = cfg.learning_rate
    warmup = int(round(total_steps * cfg.warmup_ratio))
    if cfg.schedule == 'constant':
        if warmup <= 0:
            return lambda count: lr
        return _join([_polynomial(0.0, lr, warmup), lambda count: lr], [warmup])
    if cfg.schedule == 'cosine':
        if warmup <= 0:
            return _cosine(lr, max(total_steps, 1))
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total, 2), 0)
        return _join([_polynomial(0.0, lr, warmup),
                      _cosine(lr, max(total_steps, 2) - warmup)], [warmup])
    raise ValueError(f'Unknown schedule {cfg.schedule!r}')


def make_optimizer(cfg: TrainConfig, total_steps: int
                   ) -> Tuple[Union[FusedAdamW, AdamChain], Schedule]:
    """Adam/AdamW and its schedule: the fused step by default, the optax
    chain with ``cfg.fused_optimizer=False``."""
    ca(optimizer=cfg.optimizer)
    sched = make_schedule(cfg, total_steps)
    wd = cfg.weight_decay if cfg.optimizer == 'AdamW' else 0.0
    if not cfg.fused_optimizer:
        return AdamChain(sched, weight_decay=wd, clip_norm=cfg.grad_clip_norm,
                         mu_dtype=cfg.adam_mu_dtype), sched
    return FusedAdamW(sched, weight_decay=wd, clip_norm=cfg.grad_clip_norm,
                      zero_nonfinite=cfg.debug_nans, mu_dtype=cfg.adam_mu_dtype), sched
