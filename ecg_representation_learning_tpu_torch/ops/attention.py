"""Multi-head attention with a hand-written flash forward kernel for Hopper.

Counterpart of the JAX package's ``ops/attention.py``: the counter-hash
dropout mask (``dropout_keep``), the flash forward (``_flash_kernel``, here
``csrc/flash_fwd.cu``) and the dispatcher ``attention``.  Layout is the
JAX package's: (B, H, T, D).

``flash_attention_forward`` launches the CUDA kernel for a CUDA tensor and
runs ``flash_attention_forward_reference``, its plain PyTorch version, for a
CPU tensor; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

# dropout threshold resolution: keep iff low 24 hash bits >= rate * 2^24
_DROPOUT_RES = 1 << 24
_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32): split ``c`` in 16-bit
    halves so no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _dropout_threshold(rate: float) -> int:
    return min(int(round(rate * _DROPOUT_RES)), _DROPOUT_RES - 1)


def dropout_keep(seed, bh, qpos, kpos, rate: float) -> torch.Tensor:
    """Counter-based keep mask for attention-probability dropout, bit-equal
    to the JAX ``dropout_keep``: a lowbias32-style mixer over (seed,
    batch*head index, query position, key position) in uint32 arithmetic,
    carried in int64 with every product and sum reduced mod 2^32.  The
    arguments broadcast; ``seed`` is a non-negative int32."""
    def u32(x):
        return torch.as_tensor(x, dtype=torch.int64) & _U32
    h = (_mul32(u32(seed), 0x9E3779B9) + _mul32(u32(bh), 0x85EBCA6B)
         + _mul32(u32(qpos), 0xC2B2AE35) + _mul32(u32(kpos), 0x27D4EB2F)) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h & (_DROPOUT_RES - 1)) >= _dropout_threshold(rate)


def keep_full(seed: int, b: int, h: int, t: int, rate: float,
              device=None) -> torch.Tensor:
    """(B, H, T, T) keep mask over every (bh, query, key) position (the JAX
    ``_keep_full``)."""
    bh = torch.arange(b * h, device=device)[:, None, None]
    qpos = torch.arange(t, device=device)[None, :, None]
    kpos = torch.arange(t, device=device)[None, None, :]
    return dropout_keep(seed, bh, qpos, kpos, rate).reshape(b, h, t, t)


def flash_attention_forward_reference(q, k, v, seed: int = 0,
                                      scale: Optional[float] = None,
                                      dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the flash forward kernel: f32 scores and
    softmax, the hashed keep mask applied to the normalized probabilities,
    probabilities rounded to the input dtype before the PV product (f32
    accumulation), output in the input dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, t, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = keep_full(seed, b, h, t, dropout_rate, device=q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class _FlashForward:
    """ctypes binding of ``csrc/flash_fwd.cu`` with its launch count."""

    def __init__(self):
        self.launches = 0     # kernel launches (CUDA tensors only)
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = _build.load('flash_fwd').flash_fwd
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q, k, v, seed: int, scale: float,
                 dropout_rate: float) -> torch.Tensor:
        for name, x in (('k', k), ('v', v)):
            if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
                raise ValueError(
                    f'{name} must match q in shape, dtype and device: '
                    f'{tuple(x.shape)} {x.dtype} {x.device} vs '
                    f'{tuple(q.shape)} {q.dtype} {q.device}')
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f'flash kernel takes float32 or bfloat16, got {q.dtype}')
        if q.dim() != 4:
            raise ValueError(f'q, k, v must be (B, H, T, D), got {tuple(q.shape)}')
        b, h, t, d = q.shape
        if not (1 <= d <= 128) or t < 1 or b * h < 1:
            raise ValueError(f'flash kernel needs T >= 1 and 1 <= D <= 128, '
                             f'got {tuple(q.shape)}')
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError('flash kernel needs contiguous q, k, v')
        if not (0 <= seed < 2 ** 31):
            raise ValueError(f'dropout seed must be a non-negative int32, got {seed}')
        if not (0.0 <= dropout_rate < 1.0):
            raise ValueError(f'dropout_rate must be in [0, 1), got {dropout_rate}')
        if q.device.type != 'cuda':
            raise ValueError(f'flash kernel takes CUDA tensors, got {q.device}')
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = self._entry()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, t, d, int(q.dtype == torch.bfloat16), scale, seed,
                int(dropout_rate > 0.0), _dropout_threshold(dropout_rate),
                1.0 / (1.0 - dropout_rate), stream)
        if err != 0:
            raise RuntimeError(f'flash_fwd launch failed: CUDA error {err}')
        self.launches += 1
        return out


flash_fwd_kernel = _FlashForward()


def flash_attention_forward(q, k, v, seed: int = 0, scale: Optional[float] = None,
                            dropout_rate: float = 0.0) -> torch.Tensor:
    """Flash attention forward, (B, H, T, D) -> (B, H, T, D).

    ``scale`` defaults to 1/sqrt(D).  ``dropout_rate`` > 0 drops attention
    probabilities with the hashed keep mask of ``seed``.  A CUDA tensor runs
    the kernel; a CPU tensor runs the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == 'cuda':
        return flash_fwd_kernel(q, k, v, int(seed), float(scale), float(dropout_rate))
    if q.device.type == 'cpu':
        return flash_attention_forward_reference(q, k, v, seed, scale, dropout_rate)
    raise RuntimeError(f'no flash attention for device {q.device}')


def attention(q, k, v, dropout_rate: float = 0.0, deterministic: bool = True,
              seed: int = 0, use_flash: bool = True,
              min_seq: int = 0) -> torch.Tensor:
    """Dispatch: the flash kernel whenever flash is enabled and
    T >= ``min_seq`` (with the hashed dropout mask of ``seed`` when dropout
    is active); otherwise plain attention, the JAX dispatcher's eval branch."""
    active = (not deterministic) and dropout_rate > 0.0
    if use_flash and q.shape[2] >= min_seq:
        return flash_attention_forward(q, k, v, seed, None,
                                       float(dropout_rate) if active else 0.0)
    if active:
        raise NotImplementedError(
            'dropout on the plain attention path arrives with the training slice')
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)
