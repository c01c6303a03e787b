"""One-pass AdamW over every parameter leaf, with a hand-written Hopper kernel.

Counterpart of the JAX package's ``ops/adamw_pallas.py`` (the Pallas
``_kernel``, here ``csrc/adamw.cu``).  ``adamw_update`` updates each leaf's
parameter, first moment and second moment in place:

    g'  = finite ? g * scale : 0
    mu' = b1 * mu + (1 - b1) * g'
    nu' = b2 * nu + (1 - b2) * g'^2
    p'  = p - lr * ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd * p)

``scalars`` is a 5-element f32 tensor on the leaves' device,
[scale, lr, bc1, bc2, finite], so a step reads them without a host sync.
For CUDA tensors the kernel covers every leaf in one launch (any size, mu f32
or bf16); for CPU tensors the plain version runs the same math leaf by leaf.
The port updates in place where JAX returns new arrays (JAX aliases them with
``input_output_aliases``, to the same effect).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from . import _build

_COLS = 6   # table row: p, g, mu, nu pointers, element count, first chunk


def adamw_update_reference(params, grads, mus, nus, scalars, *, b1: float,
                           b2: float, eps: float, wd: float) -> None:
    """Plain PyTorch version: the per-leaf math of the JAX ``FusedAdamW``."""
    scale, lr, bc1, bc2, finite = scalars.unbind(0)
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, mus, nus):
            g32 = torch.where(finite > 0, g.float() * scale, 0.0)
            mu2 = b1 * mu.float() + (1.0 - b1) * g32
            nu2 = b2 * nu + (1.0 - b2) * (g32 * g32)
            upd = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
            if wd:
                upd = upd + wd * p
            mu.copy_(mu2)
            nu.copy_(nu2)
            p.copy_(p - lr * upd)


class _AdamWKernel:
    """ctypes binding of ``csrc/adamw.cu`` with its launch count.

    Keeps the device table of leaf pointers, rebuilt (one small copy on the
    stream, no sync) only when a pointer or size changes."""

    def __init__(self):
        self.launches = 0     # kernel launches (CUDA tensors only)
        self._fn = None
        self._chunk = None
        self._key = None
        self._table = None
        self._n_chunks = 0

    def _entry(self):
        if self._fn is None:
            lib = _build.load('adamw')
            lib.adamw_chunk_elems.restype = ctypes.c_int
            self._chunk = lib.adamw_chunk_elems()
            fn = lib.adamw_step
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int] + [ctypes.c_float] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    @staticmethod
    def _check(params, grads, mus, nus, scalars):
        n = len(params)
        if n == 0 or not (len(grads) == len(mus) == len(nus) == n):
            raise ValueError(f'adamw needs as many grads, mus and nus as params '
                             f'(>= 1): {n}, {len(grads)}, {len(mus)}, {len(nus)}')
        dev = params[0].device
        mu_dtype = mus[0].dtype
        if mu_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f'mu must be float32 or bfloat16, got {mu_dtype}')
        for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
            for name, x, dtype in (('param', p, torch.float32), ('grad', g, torch.float32),
                                   ('mu', mu, mu_dtype), ('nu', nu, torch.float32)):
                if x.dtype != dtype:
                    raise TypeError(f'leaf {i}: {name} must be {dtype}, got {x.dtype}')
                if x.shape != p.shape or x.device != dev or not x.is_contiguous():
                    raise ValueError(f'leaf {i}: {name} must be a contiguous '
                                     f'{tuple(p.shape)} tensor on {dev}, got '
                                     f'{tuple(x.shape)} on {x.device}')
        if (scalars.shape != (5,) or scalars.dtype != torch.float32
                or scalars.device != dev or not scalars.is_contiguous()):
            raise ValueError(f'scalars must be 5 contiguous float32 on {dev}, got '
                             f'{tuple(scalars.shape)} {scalars.dtype} {scalars.device}')
        if dev.type != 'cuda':
            raise ValueError(f'adamw kernel takes CUDA tensors, got {dev}')
        return dev, mu_dtype

    def _table_for(self, dev, params, grads, mus, nus) -> None:
        key = tuple((p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel())
                    for p, g, mu, nu in zip(params, grads, mus, nus))
        if key == self._key:
            return
        rows = np.zeros((len(key), _COLS), np.int64)
        first = 0
        for i, (pp, gp, mp, np_, n) in enumerate(key):
            rows[i] = (pp, gp, mp, np_, n, first)
            first += max(1, -(-n // self._chunk))
        self._table = torch.from_numpy(rows).pin_memory().to(dev, non_blocking=True)
        self._n_chunks = first
        self._key = key

    def __call__(self, params, grads, mus, nus, scalars, *, b1: float, b2: float,
                 eps: float, wd: float) -> None:
        dev, mu_dtype = self._check(params, grads, mus, nus, scalars)
        fn = self._entry()
        self._table_for(dev, params, grads, mus, nus)
        with torch.cuda.device(dev):
            err = fn(self._table.data_ptr(), len(params), self._n_chunks,
                     scalars.data_ptr(), int(mu_dtype == torch.bfloat16), b1, 1.0 - b1,
                     b2, 1.0 - b2, eps, wd, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f'adamw_step launch failed: CUDA error {err}')
        self.launches += 1


adamw_kernel = _AdamWKernel()


def adamw_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                 scalars: torch.Tensor, *, b1: float, b2: float, eps: float,
                 wd: float) -> None:
    """One AdamW step on every leaf, in place.  CUDA tensors: one kernel
    launch; CPU tensors: the plain version."""
    params: List[torch.Tensor] = [p.detach() for p in params]
    kw = dict(b1=b1, b2=b2, eps=eps, wd=wd)
    dev = params[0].device.type
    if dev == 'cuda':
        return adamw_kernel(params, list(grads), list(mus), list(nus), scalars, **kw)
    if dev == 'cpu':
        return adamw_update_reference(params, grads, mus, nus, scalars, **kw)
    raise RuntimeError(f'no adamw for device {params[0].device}')
