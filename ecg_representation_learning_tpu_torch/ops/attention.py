"""Multi-head attention with hand-written flash kernels for Hopper.

Counterpart of the JAX package's ``ops/attention.py``: the counter-hash
dropout mask (``dropout_keep``), the flash forward with and without the row
log-sum-exp (``_flash_kernel`` and ``_flash_kernel_lse``, here
``csrc/flash_fwd.cu``), the blocked backward (``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``, here ``csrc/flash_bwd.cu``), the ``flash_attention``
gradient (the JAX ``custom_vjp``, here a ``torch.autograd.Function``) and the
dispatcher ``attention``.  Layout is the JAX package's: (B, H, T, D).

Each kernel wrapper launches its CUDA kernel for a CUDA tensor and runs its
plain PyTorch version (``*_reference``) for a CPU tensor; there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

# sequence length from which the gradient saves the forward's lse and runs
# the blocked backward kernels; below it the forward is the plain flash
# kernel and the backward recomputes the T x T probabilities in f32.  The
# JAX package's value, a TPU measurement; read at call time, so a caller may
# set it (chip_smoke.py sets 0 to put every layer on the blocked kernels).
BLOCKED_BWD_MIN_SEQ = 1024

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


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_forward_reference(q, k, v, seed: int = 0,
                                      scale: Optional[float] = None,
                                      dropout_rate: float = 0.0,
                                      return_lse: bool = False):
    """Plain PyTorch version of the flash forward kernels: f32 scores and
    softmax, the hashed keep mask applied to the normalized probabilities,
    probabilities rounded to the input dtype before the PV product (f32
    accumulation), output in the input dtype.  ``return_lse`` also returns
    the row log-sum-exp m + log(max(l, 1e-30)), (B, H, T) f32."""
    scale = _scale(q, scale)
    b, h, t, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = keep_full(seed, b, h, t, dropout_rate, device=q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.clamp(torch.exp(s - m[..., None]).sum(-1), min=1e-30))
    return out, lse


def _bwd_terms(q, k, v, do, lse, delta, seed, scale, dropout_rate):
    """p (recomputed from lse), the dropped-and-rescaled p and
    ds = p * (dpv - delta), all (B, H, T, T) f32."""
    b, h, t, _ = q.shape
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                  - lse[..., None])
    dpv = torch.matmul(do.float(), v.float().transpose(-1, -2))
    p_eff = p
    if dropout_rate > 0.0:
        keep = keep_full(seed, b, h, t, dropout_rate, device=q.device)
        inv = 1.0 / (1.0 - dropout_rate)
        p_eff = torch.where(keep, p, 0.0) * inv
        dpv = torch.where(keep, dpv, 0.0) * inv
    return p_eff, p * (dpv - delta[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta, seed: int = 0,
                           scale: Optional[float] = None,
                           dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the dQ kernel: dQ = scale * ds.K with ds
    rounded to K's dtype, in Q's dtype."""
    scale = _scale(q, scale)
    _, ds = _bwd_terms(q, k, v, do, lse, delta, seed, scale, dropout_rate)
    return (torch.matmul(ds.to(k.dtype).float(), k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, seed: int = 0,
                            scale: Optional[float] = None, dropout_rate: float = 0.0):
    """Plain PyTorch version of the dK/dV kernel: dK = scale * ds^T.Q with ds
    rounded to Q's dtype, dV = (kept, rescaled p)^T.dO in f32."""
    scale = _scale(q, scale)
    p_eff, ds = _bwd_terms(q, k, v, do, lse, delta, seed, scale, dropout_rate)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p_eff.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_blocked_reference(q, k, v, do, lse, delta, seed: int = 0,
                                     scale: Optional[float] = None,
                                     dropout_rate: float = 0.0):
    """Plain PyTorch version of the blocked backward kernels: (dQ, dK, dV)
    from p recomputed with the forward's lse, the keep mask regenerated."""
    args = (q, k, v, do, lse, delta, seed, scale, dropout_rate)
    return (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))


def flash_backward_recompute(q, k, v, g, seed: int = 0,
                             scale: Optional[float] = None,
                             dropout_rate: float = 0.0):
    """The gradient below ``BLOCKED_BWD_MIN_SEQ`` (the JAX ``_flash_bwd``
    recompute, which JAX leaves to XLA and the port to plain PyTorch): the
    T x T probabilities recomputed in f32, the keep mask regenerated."""
    scale = _scale(q, scale)
    b, h, t, _ = q.shape
    qf, kf, vf, g32 = (x.float() for x in (q, k, v, g))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(g32, vf.transpose(-1, -2))
    if dropout_rate > 0.0:
        keep = keep_full(seed, b, h, t, dropout_rate, device=q.device)
        inv = 1.0 / (1.0 - dropout_rate)
        dv = torch.matmul((torch.where(keep, p, 0.0) * inv).transpose(-1, -2), g32)
        dp = torch.where(keep, dp, 0.0) * inv
    else:
        dv = torch.matmul(p.transpose(-1, -2), g32)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name: str, q, others, seed: int, dropout_rate: float):
    """The input checks shared by the kernel wrappers: ``others`` (name,
    tensor) must match q; q is (B, H, T, D) f32 or bf16 with D <= 128, all
    contiguous CUDA tensors."""
    for other, x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f'{other} must match q in shape, dtype and device: '
                f'{tuple(x.shape)} {x.dtype} {x.device} vs '
                f'{tuple(q.shape)} {q.dtype} {q.device}')
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name} kernel takes float32 or bfloat16, got {q.dtype}')
    if q.dim() != 4:
        raise ValueError(f'q, k, v must be (B, H, T, D), got {tuple(q.shape)}')
    b, h, t, d = q.shape
    if not (1 <= d <= 128) or t < 1 or b * h < 1:
        raise ValueError(f'{name} kernel needs T >= 1 and 1 <= D <= 128, '
                         f'got {tuple(q.shape)}')
    if not all(x.is_contiguous() for x in [q] + [x for _, x in others]):
        raise ValueError(f'{name} kernel needs contiguous inputs')
    if not (0 <= seed < 2 ** 31):
        raise ValueError(f'dropout seed must be a non-negative int32, got {seed}')
    if not (0.0 <= dropout_rate < 1.0):
        raise ValueError(f'dropout_rate must be in [0, 1), got {dropout_rate}')
    if q.device.type != 'cuda':
        raise ValueError(f'{name} kernel takes CUDA tensors, got {q.device}')


def _check_rows(q, **rows):
    """lse and delta: contiguous (B, H, T) f32 on q's device."""
    for name, x in rows.items():
        if (x.shape != q.shape[:3] or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f'{name} must be a contiguous {tuple(q.shape[:3])} '
                             f'float32 tensor on {q.device}, got '
                             f'{tuple(x.shape)} {x.dtype} {x.device}')


def _dropout_args(dropout_rate: float):
    return (int(dropout_rate > 0.0), _dropout_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate))


class _Binding:
    """A ctypes entry of one ``csrc/<lib>.cu`` library with its launch count
    (the count moves only when the kernel is launched)."""

    def __init__(self, lib: str, fn: str, argtypes):
        self.launches = 0     # kernel launches (CUDA tensors only)
        self._lib, self._name, self._argtypes = lib, fn, argtypes
        self._fn = None

    def _launch(self, device, *args) -> None:
        if self._fn is None:
            fn = getattr(_build.load(self._lib), self._name)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'{self._name} launch failed: CUDA error {err}')
        self.launches += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# flash_fwd(q, k, v, o, lse, bh, t, d, is_bf16, scale, seed, use_dropout,
#           thresh, inv_keep, stream)
_FWD_ARGS = [_P] * 5 + [_I] * 4 + [_F, _I, _I, _I, _F, _P]
# flash_bwd_dq(q, k, v, do, lse, delta, dq, ...) / flash_bwd_dkv(..., dk, dv, ...)
_BWD_TAIL = [_I] * 4 + [_F, _I, _I, _I, _F, _P]


class _FlashForward(_Binding):
    """``csrc/flash_fwd.cu``: kernel #1, or with ``with_lse`` kernel #2 (the
    same entry given an lse array), each with its own launch count."""

    def __init__(self, with_lse: bool):
        super().__init__('flash_fwd', 'flash_fwd', _FWD_ARGS)
        self.with_lse = with_lse

    def __call__(self, q, k, v, seed: int, scale: float, dropout_rate: float):
        _check_qkv('flash', q, [('k', k), ('v', v)], seed, dropout_rate)
        b, h, t, d = q.shape
        out = torch.empty_like(q)
        lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
               if self.with_lse else None)
        self._launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), b * h, t, d,
                     int(q.dtype == torch.bfloat16), scale, seed,
                     *_dropout_args(dropout_rate))
        return (out, lse) if self.with_lse else out


class _FlashBackward(_Binding):
    """``csrc/flash_bwd.cu``: kernel #3 (dQ) or #4 (dK, dV)."""

    def __init__(self, fn: str):
        n_out = 1 if fn == 'flash_bwd_dq' else 2
        super().__init__('flash_bwd', fn, [_P] * (6 + n_out) + _BWD_TAIL)
        self.n_out = n_out

    def __call__(self, q, k, v, do, lse, delta, seed: int, scale: float,
                 dropout_rate: float):
        _check_qkv('flash backward', q, [('k', k), ('v', v), ('do', do)], seed,
                   dropout_rate)
        _check_rows(q, lse=lse, delta=delta)
        b, h, t, d = q.shape
        outs = [torch.empty_like(q) for _ in range(self.n_out)]
        self._launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
                     b * h, t, d, int(q.dtype == torch.bfloat16), scale, seed,
                     *_dropout_args(dropout_rate))
        return outs[0] if self.n_out == 1 else tuple(outs)


flash_fwd_kernel = _FlashForward(with_lse=False)
flash_fwd_lse_kernel = _FlashForward(with_lse=True)
flash_bwd_dq_kernel = _FlashBackward('flash_bwd_dq')
flash_bwd_dkv_kernel = _FlashBackward('flash_bwd_dkv')


def _on(x, cuda, cpu):
    """Run ``cuda()`` for a CUDA tensor, ``cpu()`` for a CPU tensor."""
    if x.device.type == 'cuda':
        return cuda()
    if x.device.type == 'cpu':
        return cpu()
    raise RuntimeError(f'no flash attention for device {x.device}')


def flash_attention_forward(q, k, v, seed: int = 0, scale: Optional[float] = None,
                            dropout_rate: float = 0.0, return_lse: bool = False):
    """Flash attention forward, (B, H, T, D) -> (B, H, T, D), and with
    ``return_lse`` also the row log-sum-exp (B, H, T) f32.

    ``scale`` defaults to 1/sqrt(D).  ``dropout_rate`` > 0 drops attention
    probabilities with the hashed keep mask of ``seed``.  A CUDA tensor runs
    the kernel (#1, or #2 for the lse); a CPU tensor the plain version."""
    scale = _scale(q, scale)
    kernel = flash_fwd_lse_kernel if return_lse else flash_fwd_kernel
    return _on(q, lambda: kernel(q, k, v, int(seed), scale, float(dropout_rate)),
               lambda: flash_attention_forward_reference(
                   q, k, v, seed, scale, dropout_rate, return_lse))


def flash_attention_backward_blocked(q, k, v, out, lse, g, seed: int = 0,
                                     scale: Optional[float] = None,
                                     dropout_rate: float = 0.0):
    """Gradient of flash attention from the forward's ``out`` and ``lse``,
    never forming the T x T probabilities in device memory: (dQ, dK, dV).

    delta = rowsum(dO * O) is a PyTorch reduction here, outside the
    kernels, as it sits outside the Pallas kernels in JAX.  A CUDA tensor
    runs kernels #3 and #4; a CPU tensor the plain version."""
    scale = _scale(q, scale)
    g = g.contiguous()
    # the multiply promotes a bf16 ``out`` to f32 as it reads it: the same
    # exact products as casting it first, one kernel fewer
    delta = (g.float() * out).sum(-1)

    def cuda():
        args = (q, k, v, g, lse, delta, int(seed), scale, float(dropout_rate))
        return (flash_bwd_dq_kernel(*args), *flash_bwd_dkv_kernel(*args))
    return _on(q, cuda, lambda: flash_backward_blocked_reference(
        q, k, v, g, lse, delta, seed, scale, dropout_rate))


class FlashAttention(torch.autograd.Function):
    """The gradient of flash attention (the JAX ``custom_vjp`` of
    ``flash_attention``).  For T >= ``BLOCKED_BWD_MIN_SEQ`` the forward runs
    the lse kernel and saves (q, k, v, out, lse) for the blocked backward
    kernels; below it the forward is the plain flash kernel and the backward
    the f32 recompute.  Both backwards regenerate the hashed keep mask."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, dropout_rate):
        ctx.args = (seed, scale, dropout_rate)
        if q.shape[2] >= BLOCKED_BWD_MIN_SEQ:
            out, lse = flash_attention_forward(q, k, v, seed, scale, dropout_rate,
                                               return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = flash_attention_forward(q, k, v, seed, scale, dropout_rate)
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if len(saved) == 5:
            grads = flash_attention_backward_blocked(*saved, g, *ctx.args)
        else:
            grads = flash_backward_recompute(*saved, g, *ctx.args)
        return (*grads, None, None, None)


def flash_attention(q, k, v, seed: int = 0, scale: Optional[float] = None,
                    dropout_rate: float = 0.0) -> torch.Tensor:
    """Multi-head attention, (B, H, T, D) -> (B, H, T, D), differentiable.

    Without a gradient to record (inference, or no input requiring grad)
    this is the flash forward alone, as the JAX primal is; otherwise the
    :class:`FlashAttention` function."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, int(seed), _scale(q, scale),
                                    float(dropout_rate))
    return flash_attention_forward(q, k, v, seed, scale, dropout_rate)


def attention(q, k, v, dropout_rate: float = 0.0, deterministic: bool = True,
              seed: int = 0, use_flash: bool = True, min_seq: int = 0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dispatch: flash attention whenever flash is enabled and
    T >= ``min_seq`` (with the hashed dropout mask of ``seed`` when dropout
    is active); otherwise plain attention.  Its dropout, as in JAX, compares
    raw 32-bit draws from ``generator`` (on q's device) against
    round((1 - rate) * (2^32 - 1)) and multiplies after the cast to v's
    dtype."""
    active = (not deterministic) and dropout_rate > 0.0
    if use_flash and q.shape[2] >= min_seq:
        return flash_attention(q, k, v, seed if active else 0, None,
                               float(dropout_rate) if active else 0.0)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if active:
        if generator is None:
            raise ValueError('dropout on the plain attention path needs a generator')
        bits = torch.randint(0, 1 << 32, probs.shape, dtype=torch.int64,
                             generator=generator, device=probs.device)
        thresh = round((1.0 - dropout_rate) * float(_U32))
        probs = probs * (bits < thresh).to(v.dtype) / (1.0 - dropout_rate)
    return torch.matmul(probs, v)
