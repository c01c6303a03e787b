"""Train-step mechanics: gradient accumulation and the shared update tail.

Counterpart of the JAX package's ``train/loop.py``.  ``grad_accum`` runs the
microbatches one after another (JAX scans them), summing their gradients in
the parameters' ``.grad`` and taking the mean; ``finish_update`` is the
update tail -- global norm and the device-side non-finite counter, the
optimizer step, the parameter EMA.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from .optim import FusedAdamW, FusedAdamWState, global_norm


def grad_accum(micro_fn: Callable[[torch.Tensor], Tuple[Any, torch.Tensor]],
               params: Dict[str, torch.Tensor], idx: torch.Tensor,
               accum: int) -> Tuple[List[Any], Dict[str, torch.Tensor]]:
    """Run ``micro_fn(idx_k) -> (aux, loss)`` over ``accum`` equal slices of
    ``idx`` (the JAX ``idx.reshape(accum, -1)``), back-propagating each loss,
    and return ``([aux_k], mean grads)``.  Activation memory is one
    microbatch's; the mean of the microbatch gradient means equals the
    full-batch gradient mean."""
    for p in params.values():
        p.grad = None
    aux = []
    for idx_k in idx.reshape(accum, -1):
        a, loss = micro_fn(idx_k)
        loss.backward()
        aux.append(a)
    grads = {k: p.grad for k, p in params.items()}
    if accum > 1:
        torch._foreach_div_(list(grads.values()), float(accum))
    return aux, grads


def finish_update(optimizer: FusedAdamW, cfg, opt_state: FusedAdamWState,
                  params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  nonfinite_count: torch.Tensor, ema: Dict[str, torch.Tensor] = None
                  ) -> Tuple[FusedAdamWState, torch.Tensor, torch.Tensor]:
    """The update tail.  Returns ``(opt_state, grad_norm, nonfinite_count)``;
    ``params`` (and ``ema`` when ``cfg.ema_decay > 0``) change in place.

    A non-finite global gradient norm adds one to ``nonfinite_count`` on the
    device (the host raises at its next sync), and with ``cfg.debug_nans``
    the fused step zeroes that step's gradients by select, so the parameters
    are never poisoned."""
    grad_norm = global_norm(list(grads.values()))
    nonfinite_count = nonfinite_count + (~torch.isfinite(grad_norm)).to(torch.int32)
    opt_state = optimizer.apply(grads, opt_state, params, g_norm=grad_norm)
    if cfg.ema_decay > 0:   # e * d + p * (1 - d), d and 1 - d in f32 as in JAX
        d = np.float32(cfg.ema_decay)
        e, p = list(ema.values()), [params[k] for k in ema]
        with torch.no_grad():
            torch._foreach_mul_(e, float(d))
            torch._foreach_add_(e, torch._foreach_mul(p, float(np.float32(1) - d)))
    return opt_state, grad_norm, nonfinite_count
