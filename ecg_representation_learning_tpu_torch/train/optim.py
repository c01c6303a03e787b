"""The fused AdamW step and the learning-rate schedules.

Counterpart of the JAX package's ``train/optim.py``: ``FusedAdamW`` with its
exact semantics, ``make_schedule`` (optax's warmup-cosine, cosine, linear
warmup + constant, computed in f32 as optax does) and ``make_optimizer`` for
the fused path.  The optax chain (``fused_optimizer=False``) is not ported.

``FusedAdamW.apply`` takes the global gradient norm (a PyTorch reduction,
as it was XLA outside Pallas), folds the clip and the non-finite select into
the scalars ``[scale, lr, bc1, bc2, finite]`` on the device, and runs
``ops/adamw.adamw_update``: on the GPU one kernel launch over every leaf
(``ops/csrc/adamw.cu``), in place.  Nothing in a step waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import TrainConfig
from ..ops.adamw import adamw_update
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


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every element of every tensor), f32, on the
    tensors' device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


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
        # the in-place update; ops.adamw.adamw_update_reference runs the plain
        # version on any device (chip_smoke.py's twin uses it on the card)
        self.update = adamw_update

    def init(self, params: Dict[str, torch.Tensor]) -> FusedAdamWState:
        return FusedAdamWState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(_F32(lr(count) if callable(lr) else lr))

    def scalars(self, g_norm: torch.Tensor, count: int) -> torch.Tensor:
        """[scale, lr, bc1, bc2, finite] as 5 f32 on g_norm's device for the
        step that takes the count from ``count`` to ``count + 1``."""
        dev = g_norm.device
        scale = torch.ones((), device=dev)
        finite = torch.ones((), device=dev)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(g_norm, min=1e-16), max=1.0)
        if self.zero_nonfinite:
            ok = torch.isfinite(g_norm)
            scale = torch.where(ok, scale, 1.0)
            finite = ok.float()
        c = _F32(count + 1)
        host = torch.tensor([self.lr_at(count), _F32(1) - _F32(self.b1) ** c,
                             _F32(1) - _F32(self.b2) ** c], dtype=torch.float32)
        if dev.type == 'cuda':   # pinned + async: the step never waits
            host = host.pin_memory().to(dev, non_blocking=True)
        return torch.cat([scale.reshape(1).float(), host, finite.reshape(1)])

    def apply(self, grads: Dict[str, torch.Tensor], state: FusedAdamWState,
              params: Dict[str, torch.Tensor],
              g_norm: Optional[torch.Tensor] = None) -> FusedAdamWState:
        """One step: updates ``params`` and the moments in place and returns
        the state with its count advanced.  ``g_norm`` may be passed when the
        caller has it already."""
        names = list(params)
        if g_norm is None:
            g_norm = global_norm([grads[k] for k in names])
        self.update([params[k] for k in names], [grads[k] for k in names],
                     [state.mu[k] for k in names], [state.nu[k] for k in names],
                     self.scalars(g_norm, state.count), b1=self.b1, b2=self.b2,
                     eps=self.eps, wd=self.weight_decay)
        return dataclasses.replace(state, count=state.count + 1)


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


def make_optimizer(cfg: TrainConfig, total_steps: int) -> Tuple[FusedAdamW, Schedule]:
    """The fused Adam/AdamW and its schedule (``cfg.fused_optimizer``)."""
    ca(optimizer=cfg.optimizer)
    sched = make_schedule(cfg, total_steps)
    return FusedAdamW(
        sched, weight_decay=cfg.weight_decay if cfg.optimizer == 'AdamW' else 0.0,
        clip_norm=cfg.grad_clip_norm, zero_nonfinite=cfg.debug_nans,
        mu_dtype=cfg.adam_mu_dtype), sched
