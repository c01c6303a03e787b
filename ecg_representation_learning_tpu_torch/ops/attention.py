"""Multi-head attention with hand-written flash kernels for Hopper.

Counterpart of the JAX package's ``ops/attention.py``: the counter-hash
dropout mask (``dropout_keep``), the flash forward with and without the row
log-sum-exp (``_flash_kernel`` and ``_flash_kernel_lse``, here
``csrc/flash_fwd.cu``), the blocked backward (``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``, here ``csrc/flash_bwd.cu``), the ``flash_attention``
gradient (the JAX ``custom_vjp``, here a ``torch.autograd.Function``) and the
dispatcher ``attention``.  Layout is the JAX package's: (B, H, T, D).

Beyond the JAX package every kernel and plain version takes a band and
grouped KV heads (``csrc/flash_mask.cuh``): ``causal`` (query i sees keys
j <= i), ``window_left`` W (keys j >= i - W; -1: no bound) and k, v of
(B, H_kv, T, D) with H a multiple of H_kv, query head h reading KV head
h // (H / H_kv).  The kernels visit only the tiles that meet the band; their
defaults (not causal, no window, H_kv = H) are the kernels as they were.

Each kernel wrapper launches its CUDA kernel for a CUDA tensor and runs its
plain PyTorch version (``*_reference``) for a CPU tensor; there is no
fallback from one to the other.

A dropout seed is a non-negative int32: a Python int, or a 0-d int32 tensor
on q's device -- a slot of a training step's tape (``train/dispatch.py``),
which kernels #1-#4 read from device memory (``seed_dev``), so a CUDA graph
replaying the launch takes each step's seed without a host value in the
launch; the plain versions hash the tensor's value, with the int's bits.

Kernel #1 is also the registered op ``ecg_tpu_torch::flash_fwd``
(``flash_fwd_op``), which the forward calls while ``torch.export`` traces
it, so an exported program keeps the kernel as one node
(``models/export_artifact.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional

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


def raw_bits(shape, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Raw 32-bit draws (int64) for the plain attention path's dropout."""
    return torch.randint(0, 1 << 32, shape, dtype=torch.int64, generator=generator,
                         device=device)


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
    arguments broadcast; ``seed`` is a non-negative int32, as an int or a
    0-d integer tensor."""
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
              device=None, bh_offset: int = 0) -> torch.Tensor:
    """(B, H, T, T) keep mask over every (bh, query, key) position (the JAX
    ``_keep_full``); head bh hashes ``bh_offset + bh``, so rows of a larger
    batch held from row r on take that batch's masks with ``bh_offset =
    r * H``."""
    bh = torch.arange(bh_offset, bh_offset + b * h, device=device)[:, None, None]
    qpos = torch.arange(t, device=device)[None, :, None]
    kpos = torch.arange(t, device=device)[None, None, :]
    return dropout_keep(seed, bh, qpos, kpos, rate).reshape(b, h, t, t)


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def band_mask(t: int, causal: bool = False, window_left: int = -1,
              device=None) -> Optional[torch.Tensor]:
    """(T, T) bool of the (query, key) pairs the band lets attention see:
    key j <= query i when ``causal``, j >= i - ``window_left`` when it is
    >= 0; None when it lets every pair through."""
    if not causal and window_left < 0:
        return None
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    vis = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        vis &= j <= i
    if window_left >= 0:
        vis &= j >= i - window_left
    return vis


def expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    """k or v (B, H_kv, T, D) as (B, ``heads``, T, D): each KV head repeated
    for its group of query heads."""
    g = heads // x.shape[1]
    return x if g == 1 else x.repeat_interleave(g, dim=1)


def fold_kv(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """A per-query-head (B, H, T, D) gradient of k or v summed over each
    group: (B, ``kv_heads``, T, D)."""
    b, h, t, d = x.shape
    return x if h == kv_heads else x.reshape(b, kv_heads, h // kv_heads, t, d).sum(2)


def flash_attention_forward_reference(q, k, v, seed: int = 0,
                                      scale: Optional[float] = None,
                                      dropout_rate: float = 0.0,
                                      return_lse: bool = False, bh_offset: int = 0,
                                      causal: bool = False, window_left: int = -1):
    """Plain PyTorch version of the flash forward kernels: f32 scores and
    softmax over the band's keys (``band_mask``; k and v expanded to q's
    heads), the hashed keep mask applied to the normalized probabilities,
    probabilities rounded to the input dtype before the PV product (f32
    accumulation), output in the input dtype.  ``return_lse`` also returns
    the row log-sum-exp m + log(max(l, 1e-30)), (B, H, T) f32.  The masks
    are ``keep_full``'s with ``bh_offset``."""
    scale = _scale(q, scale)
    b, h, t, _ = q.shape
    k, v = expand_kv(k, h), expand_kv(v, h)
    vis = band_mask(t, causal, window_left, q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if vis is not None:     # a row that saw no key would be uniform: 0 instead
        p = torch.where(vis, p, 0.0)
    if dropout_rate > 0.0:
        keep = keep_full(seed, b, h, t, dropout_rate, device=q.device, bh_offset=bh_offset)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.clamp(torch.exp(s - m[..., None]).sum(-1), min=1e-30))
    return out, lse


def _bwd_terms(q, k, v, do, lse, delta, seed, scale, dropout_rate, bh_offset,
               causal=False, window_left=-1):
    """p (recomputed from lse, 0 outside the band), the dropped-and-rescaled
    p and ds = p * (dpv - delta), all (B, H, T, T) f32; k and v at q's heads."""
    b, h, t, _ = q.shape
    p = torch.exp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                  - lse[..., None])
    vis = band_mask(t, causal, window_left, q.device)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    dpv = torch.matmul(do.float(), v.float().transpose(-1, -2))
    p_eff = p
    if dropout_rate > 0.0:
        keep = keep_full(seed, b, h, t, dropout_rate, device=q.device, bh_offset=bh_offset)
        inv = 1.0 / (1.0 - dropout_rate)
        p_eff = torch.where(keep, p, 0.0) * inv
        dpv = torch.where(keep, dpv, 0.0) * inv
    return p_eff, p * (dpv - delta[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta, seed: int = 0,
                           scale: Optional[float] = None,
                           dropout_rate: float = 0.0, bh_offset: int = 0,
                           causal: bool = False, window_left: int = -1) -> torch.Tensor:
    """Plain PyTorch version of the dQ kernel: dQ = scale * ds.K with ds
    rounded to K's dtype, in Q's dtype."""
    scale = _scale(q, scale)
    k, v = expand_kv(k, q.shape[1]), expand_kv(v, q.shape[1])
    _, ds = _bwd_terms(q, k, v, do, lse, delta, seed, scale, dropout_rate, bh_offset,
                       causal, window_left)
    return (torch.matmul(ds.to(k.dtype).float(), k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, seed: int = 0,
                            scale: Optional[float] = None, dropout_rate: float = 0.0,
                            bh_offset: int = 0, causal: bool = False, window_left: int = -1):
    """Plain PyTorch version of the dK/dV kernel: dK = scale * ds^T.Q with ds
    rounded to Q's dtype, dV = (kept, rescaled p)^T.dO in f32, each summed in
    f32 over the query heads of a KV head's group."""
    scale = _scale(q, scale)
    kv_heads = k.shape[1]
    ke, ve = expand_kv(k, q.shape[1]), expand_kv(v, q.shape[1])
    p_eff, ds = _bwd_terms(q, ke, ve, do, lse, delta, seed, scale, dropout_rate, bh_offset,
                           causal, window_left)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p_eff.transpose(-1, -2), do.float())
    return fold_kv(dk, kv_heads).to(k.dtype), fold_kv(dv, kv_heads).to(v.dtype)


def flash_backward_blocked_reference(q, k, v, do, lse, delta, seed: int = 0,
                                     scale: Optional[float] = None,
                                     dropout_rate: float = 0.0, bh_offset: int = 0,
                                     causal: bool = False, window_left: int = -1):
    """Plain PyTorch version of the blocked backward kernels: (dQ, dK, dV)
    from p recomputed with the forward's lse, the keep mask regenerated."""
    args = (q, k, v, do, lse, delta, seed, scale, dropout_rate, bh_offset, causal, window_left)
    return (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))


def flash_backward_recompute(q, k, v, g, seed: int = 0,
                             scale: Optional[float] = None,
                             dropout_rate: float = 0.0, bh_offset: int = 0,
                             causal: bool = False, window_left: int = -1):
    """The gradient below ``BLOCKED_BWD_MIN_SEQ`` (the JAX ``_flash_bwd``
    recompute, which JAX leaves to XLA and the port to plain PyTorch): the
    T x T probabilities recomputed in f32 over the band's keys, the keep
    mask regenerated, dK and dV summed over each KV head's group."""
    scale = _scale(q, scale)
    b, h, t, _ = q.shape
    kv_heads = k.shape[1]
    qf, kf, vf, g32 = (x.float() for x in (q, expand_kv(k, h), expand_kv(v, h), g))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = band_mask(t, causal, window_left, q.device)
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if vis is not None:
        p = torch.where(vis, p, 0.0)
    dp = torch.matmul(g32, vf.transpose(-1, -2))
    if dropout_rate > 0.0:
        keep = keep_full(seed, b, h, t, dropout_rate, device=q.device, bh_offset=bh_offset)
        inv = 1.0 / (1.0 - dropout_rate)
        dv = torch.matmul((torch.where(keep, p, 0.0) * inv).transpose(-1, -2), g32)
        dp = torch.where(keep, dp, 0.0) * inv
    else:
        dv = torch.matmul(p.transpose(-1, -2), g32)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return (dq.to(q.dtype), fold_kv(dk, kv_heads).to(k.dtype),
            fold_kv(dv, kv_heads).to(v.dtype))


def _seed_arg(seed):
    """A seed as the kernels and plain versions take it: a tensor as it is
    (its value stays on the device), anything else as an int."""
    return seed if isinstance(seed, torch.Tensor) else int(seed)


def _check_qkv(name: str, q, others, seed, dropout_rate: float,
               device_type: str = 'cuda', bh_offset: int = 0, kv=(),
               window_left: int = -1):
    """The input checks shared by the kernel wrappers: ``others`` (name,
    tensor) must match q; ``kv`` (name, tensor) are k and v, (B, H_kv, T, D)
    of q's dtype and device with H a multiple of H_kv; q is (B, H, T, D) f32
    or bf16 with D <= 128, all contiguous tensors on a ``device_type``
    device.  A tensor seed is one int32 on q's device; its range is checked
    where the tape is filled (reading it here would wait for the device)."""
    for other, x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f'{other} must match q in shape, dtype and device: '
                f'{tuple(x.shape)} {x.dtype} {x.device} vs '
                f'{tuple(q.shape)} {q.dtype} {q.device}')
    for other, x in kv:
        if (x.dim() != 4 or x.shape[0] != q.shape[0] or x.shape[2:] != q.shape[2:]
                or x.shape[1] < 1 or q.shape[1] % x.shape[1] or x.shape != kv[0][1].shape
                or x.dtype != q.dtype or x.device != q.device):
            raise ValueError(
                f'{other} must be (B, H_kv, T, D) with H a multiple of H_kv, of q\'s dtype '
                f'and device: {tuple(x.shape)} {x.dtype} {x.device} vs q '
                f'{tuple(q.shape)} {q.dtype} {q.device}')
    if window_left < -1:
        raise ValueError(f'window_left must be >= 0, or -1 for none; got {window_left}')
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name} kernel takes float32 or bfloat16, got {q.dtype}')
    if q.dim() != 4:
        raise ValueError(f'q, k, v must be (B, H, T, D), got {tuple(q.shape)}')
    b, h, t, d = q.shape
    if not (1 <= d <= 128) or t < 1 or b * h < 1:
        raise ValueError(f'{name} kernel needs T >= 1 and 1 <= D <= 128, '
                         f'got {tuple(q.shape)}')
    if not all(x.is_contiguous() for x in [q] + [x for _, x in (*others, *kv)]):
        raise ValueError(f'{name} kernel needs contiguous inputs')
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype != torch.int32 or seed.device != q.device:
            raise ValueError(f'a tensor dropout seed must be one int32 on {q.device}, got '
                             f'{tuple(seed.shape)} {seed.dtype} {seed.device}')
    elif not (0 <= seed < 2 ** 31):
        raise ValueError(f'dropout seed must be a non-negative int32, got {seed}')
    if not (0 <= bh_offset < 2 ** 31):
        raise ValueError(f'bh_offset must be a non-negative int32, got {bh_offset}')
    if not (0.0 <= dropout_rate < 1.0):
        raise ValueError(f'dropout_rate must be in [0, 1), got {dropout_rate}')
    if q.device.type != device_type:
        raise ValueError(f'{name} kernel takes {device_type.upper()} tensors, got {q.device}')


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


def _seed_args(seed):
    """(seed, seed_dev) of a launch: an int by value, a tensor by address."""
    if isinstance(seed, torch.Tensor):
        return 0, seed.data_ptr()
    return seed, None


def _band_args(q, k, causal: bool, window_left: int):
    """(heads, kv_heads, causal, window) of a launch."""
    return q.shape[1], k.shape[1], int(bool(causal)), int(window_left)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# flash_bwd_dq(q, k, v, do, lse, delta, dq, ...) / flash_bwd_dkv(..., dk, dv, ...)
_BWD_TAIL = [_I] * 8 + [_F, _I, _P, _I, _I, _I, _F, _P]
# flash_fwd(q, k, v, o, lse, bh, t, d, heads, kv_heads, causal, window, is_bf16, scale,
#           seed, seed_dev, bh_offset, use_dropout, thresh, inv_keep, stream)
FLASH_FWD = _build.CtypesLibrary('flash_fwd', {
    'flash_fwd': [_P] * 5 + [_I] * 8 + [_F, _I, _P, _I, _I, _I, _F, _P]})
FLASH_BWD = _build.CtypesLibrary('flash_bwd', {'flash_bwd_dq': [_P] * 7 + _BWD_TAIL,
                                               'flash_bwd_dkv': [_P] * 8 + _BWD_TAIL})


class _FlashForward:
    """``csrc/flash_fwd.cu``: kernel #1, or with ``with_lse`` kernel #2 (the
    same entry given an lse array), each counted under its own name."""

    def __init__(self, with_lse: bool):
        self.with_lse = with_lse
        self.counter = 'flash_fwd_lse' if with_lse else 'flash_fwd'

    def __call__(self, q, k, v, seed, scale: float, dropout_rate: float,
                 bh_offset: int = 0, causal: bool = False, window_left: int = -1):
        """``seed``: an int, or one int32 on the device (read by the kernel)."""
        _check_qkv('flash', q, [], seed, dropout_rate, bh_offset=bh_offset,
                   kv=[('k', k), ('v', v)], window_left=window_left)
        b, h, t, d = q.shape
        out = torch.empty_like(q)
        lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
               if self.with_lse else None)
        FLASH_FWD.launch('flash_fwd', self.counter, q.device, (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b * h, t, d,
            *_band_args(q, k, causal, window_left),
            int(q.dtype == torch.bfloat16), scale, *_seed_args(seed), bh_offset,
            *_dropout_args(dropout_rate)))
        return (out, lse) if self.with_lse else out


class _FlashBackward:
    """``csrc/flash_bwd.cu``: kernel #3 (dQ) or #4 (dK, dV)."""

    def __init__(self, fn: str):
        self.fn = fn
        self.n_out = 1 if fn == 'flash_bwd_dq' else 2

    def __call__(self, q, k, v, do, lse, delta, seed, scale: float,
                 dropout_rate: float, bh_offset: int = 0, causal: bool = False,
                 window_left: int = -1):
        _check_qkv('flash backward', q, [('do', do)], seed, dropout_rate, bh_offset=bh_offset,
                   kv=[('k', k), ('v', v)], window_left=window_left)
        _check_rows(q, lse=lse, delta=delta)
        b, h, t, d = q.shape
        outs = ([torch.empty_like(q)] if self.n_out == 1
                else [torch.empty_like(k), torch.empty_like(v)])
        FLASH_BWD.launch(self.fn, self.fn, q.device, (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(o.data_ptr() for o in outs), b * h, t, d,
            *_band_args(q, k, causal, window_left),
            int(q.dtype == torch.bfloat16), scale, *_seed_args(seed), bh_offset,
            *_dropout_args(dropout_rate)))
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


@torch.library.custom_op('ecg_tpu_torch::flash_fwd', mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int,
                 scale: float, dropout_rate: float) -> torch.Tensor:
    """Kernel #1 as a registered op, so that ``torch.export`` keeps it as one
    node of the graph (the ctypes binding cannot be traced).  Its CUDA kernel
    is ``flash_fwd_kernel``, its CPU kernel the plain version behind the
    binding's input checks; any other device raises."""
    raise RuntimeError(f'ecg_tpu_torch::flash_fwd has no kernel for {q.device}')


@flash_fwd_op.register_kernel('cuda')
def _(q, k, v, seed, scale, dropout_rate):
    return flash_fwd_kernel(q, k, v, seed, scale, dropout_rate)


@flash_fwd_op.register_kernel('cpu')
def _(q, k, v, seed, scale, dropout_rate):
    _check_qkv('flash', q, [], seed, dropout_rate, device_type='cpu', kv=[('k', k), ('v', v)])
    return flash_attention_forward_reference(q, k, v, seed, scale, dropout_rate)


@flash_fwd_op.register_fake
def _(q, k, v, seed, scale, dropout_rate):
    return torch.empty_like(q)


def flash_attention_forward(q, k, v, seed: int = 0, scale: Optional[float] = None,
                            dropout_rate: float = 0.0, return_lse: bool = False,
                            bh_offset: int = 0, causal: bool = False, window_left: int = -1):
    """Flash attention forward, (B, H, T, D) -> (B, H, T, D), and with
    ``return_lse`` also the row log-sum-exp (B, H, T) f32.

    ``scale`` defaults to 1/sqrt(D).  ``dropout_rate`` > 0 drops attention
    probabilities with the hashed keep mask of ``seed`` (an int or a 0-d
    int32 tensor; head bh hashing ``bh_offset + bh``).  ``causal`` and
    ``window_left`` band the keys; k and v may hold fewer heads than q
    (module docstring).  A CUDA tensor runs the kernel (#1, or #2 for the
    lse); a CPU tensor the plain version.  Under ``torch.export`` the
    forward without lse is the op ``ecg_tpu_torch::flash_fwd``
    (``flash_fwd_op``, no band, one head count); eager calls use the binding
    directly and skip the dispatcher."""
    scale = _scale(q, scale)
    if not return_lse and torch.compiler.is_exporting():
        if causal or window_left >= 0 or k.shape[1] != q.shape[1]:
            raise NotImplementedError('the exported flash op has no band and one head count')
        return flash_fwd_op(q, k, v, int(seed), scale, float(dropout_rate))
    kernel = flash_fwd_lse_kernel if return_lse else flash_fwd_kernel
    return _on(q, lambda: kernel(q, k, v, _seed_arg(seed), scale, float(dropout_rate),
                                 int(bh_offset), causal, int(window_left)),
               lambda: flash_attention_forward_reference(
                   q, k, v, seed, scale, dropout_rate, return_lse, bh_offset, causal,
                   window_left))


def flash_attention_backward_blocked(q, k, v, out, lse, g, seed: int = 0,
                                     scale: Optional[float] = None,
                                     dropout_rate: float = 0.0, bh_offset: int = 0,
                                     causal: bool = False, window_left: int = -1):
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
        args = (q, k, v, g, lse, delta, _seed_arg(seed), scale, float(dropout_rate),
                int(bh_offset), causal, int(window_left))
        return (flash_bwd_dq_kernel(*args), *flash_bwd_dkv_kernel(*args))
    return _on(q, cuda, lambda: flash_backward_blocked_reference(
        q, k, v, g, lse, delta, seed, scale, dropout_rate, bh_offset, causal, window_left))


class FlashAttention(torch.autograd.Function):
    """The gradient of flash attention (the JAX ``custom_vjp`` of
    ``flash_attention``).  For T >= ``BLOCKED_BWD_MIN_SEQ`` the forward runs
    the lse kernel and saves (q, k, v, out, lse) for the blocked backward
    kernels; below it the forward is the plain flash kernel and the backward
    the f32 recompute.  Both backwards regenerate the hashed keep mask."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, dropout_rate, bh_offset, causal=False,
                window_left=-1):
        ctx.args = (seed, scale, dropout_rate, bh_offset, causal, window_left)
        band = dict(bh_offset=bh_offset, causal=causal, window_left=window_left)
        if q.shape[2] >= BLOCKED_BWD_MIN_SEQ:
            out, lse = flash_attention_forward(q, k, v, seed, scale, dropout_rate,
                                               return_lse=True, **band)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = flash_attention_forward(q, k, v, seed, scale, dropout_rate, **band)
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if len(saved) == 5:
            grads = flash_attention_backward_blocked(*saved, g, *ctx.args)
        else:
            grads = flash_backward_recompute(*saved, g, *ctx.args)
        return (*grads, None, None, None, None, None, None)


def flash_attention(q, k, v, seed: int = 0, scale: Optional[float] = None,
                    dropout_rate: float = 0.0, bh_offset: int = 0, causal: bool = False,
                    window_left: int = -1) -> torch.Tensor:
    """Multi-head attention, (B, H, T, D) -> (B, H, T, D), differentiable;
    k and v (B, H_kv, T, D), the keys banded by ``causal`` and
    ``window_left`` (module docstring).

    Without a gradient to record (inference, or no input requiring grad)
    this is the flash forward alone, as the JAX primal is; otherwise the
    :class:`FlashAttention` function.  Head bh's dropout mask hashes
    ``bh_offset + bh``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, _seed_arg(seed), _scale(q, scale),
                                    float(dropout_rate), int(bh_offset), bool(causal),
                                    int(window_left))
    return flash_attention_forward(q, k, v, seed, scale, dropout_rate, bh_offset=bh_offset,
                                   causal=causal, window_left=window_left)


# --- the mesh's flash wrapping (the JAX flash_tp_context) -----------------
# Under tensor parallelism a rank holds a (batch shard, head shard) of q/k/v
# (parallel/mesh.py); JAX shard_map-wraps the Pallas kernel over the mesh, and
# the kernel indexes its LOCAL bh with the seed folded by the shard's
# coordinates.  The trainers set the context around a forward when the mesh's
# model axis is > 1.
_TP_CTX = None


class flash_tp_context:
    """Route :func:`attention` through :func:`flash_attention_sharded` over
    ``mesh`` (q/k/v local: batch over ``batch_axis``, heads over
    ``head_axis``).  Megatron activation layout, so the wrap runs no
    collective."""

    def __init__(self, mesh, batch_axis: str = 'data', head_axis: str = 'model'):
        self.ctx = (mesh, batch_axis, head_axis)

    def __enter__(self):
        global _TP_CTX
        self._old, _TP_CTX = _TP_CTX, self.ctx
        return self

    def __exit__(self, *exc):
        global _TP_CTX
        _TP_CTX = self._old
        return False


def fold_seed(seed: int, shard: int) -> int:
    """The JAX shard wrap's per-shard seed: (seed + (shard + 1) * 0x3C6EF3)
    & 0x7FFFFFFF (int32 arithmetic; the wrap-around does not change the low
    31 bits)."""
    return (int(seed) + (int(shard) + 1) * 0x3C6EF3) & 0x7FFFFFFF


def flash_attention_sharded(q, k, v, mesh, batch_axis: str = 'data',
                            head_axis: str = 'model', seed: int = 0,
                            dropout_rate: float = 0.0) -> torch.Tensor:
    """The JAX ``flash_attention_sharded`` on this rank: ``q``, ``k``, ``v``
    are the rank's (B / n_data, H / n_model, T, D) block and go through the
    flash kernels as they are, indexed by their local bh, with the dropout
    seed folded by the shard index i_data * n_model + i_model, so masks stay
    decorrelated across shards.  No communication."""
    if dropout_rate > 0.0:
        shard = mesh.index(batch_axis) * mesh.shape[head_axis] + mesh.index(head_axis)
        seed = fold_seed(seed, shard)
    return flash_attention(q, k, v, seed, None, dropout_rate)


def attention(q, k, v, dropout_rate: float = 0.0, deterministic: bool = True,
              seed=0, use_flash: bool = True, min_seq: int = 0,
              generator: Optional[torch.Generator] = None,
              bh_offset: int = 0,
              draw_bits: Optional[Callable[[torch.Size, torch.device], torch.Tensor]] = None,
              causal: bool = False, window_left: int = -1) -> torch.Tensor:
    """Dispatch: flash attention whenever flash is enabled and
    T >= ``min_seq`` (with the hashed dropout mask of ``seed`` when dropout
    is active, head bh hashing ``bh_offset + bh``: a data-parallel rank's
    rows take the global batch's masks), through
    :func:`flash_attention_sharded` inside :class:`flash_tp_context`;
    otherwise plain attention.  ``causal``, ``window_left`` and k, v with
    fewer heads than q hold on both paths (module docstring; the mesh's wrap
    takes neither).  Its dropout, as in JAX, compares
    raw 32-bit draws from ``generator`` (on q's device; or, when given,
    ``draw_bits(shape, device)``, as a ``DropoutRng`` draws them) against
    round((1 - rate) * (2^32 - 1)) and multiplies after the cast to v's
    dtype."""
    active = (not deterministic) and dropout_rate > 0.0
    if use_flash and q.shape[2] >= min_seq:
        rate = float(dropout_rate) if active else 0.0
        if _TP_CTX is not None:
            if causal or window_left >= 0 or k.shape[1] != q.shape[1]:
                raise NotImplementedError('the mesh\'s flash wrap takes no band and one '
                                          'head count')
            mesh, batch_axis, head_axis = _TP_CTX
            return flash_attention_sharded(q, k, v, mesh, batch_axis, head_axis,
                                           seed if active else 0, rate)
        return flash_attention(q, k, v, seed if active else 0, None, rate,
                               bh_offset if active else 0, causal, window_left)
    scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = expand_kv(k, q.shape[1]), expand_kv(v, q.shape[1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    vis = band_mask(q.shape[2], causal, window_left, q.device)
    if vis is not None:
        logits = torch.where(vis, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if vis is not None:
        probs = torch.where(vis, probs, 0.0)
    probs = probs.to(v.dtype)
    if active:
        if draw_bits is None:
            if generator is None:
                raise ValueError('dropout on the plain attention path needs a generator')
            draw_bits = functools.partial(raw_bits, generator=generator)
        bits = draw_bits(probs.shape, probs.device)
        thresh = round((1.0 - dropout_rate) * float(_U32))
        probs = probs * (bits < thresh).to(v.dtype) / (1.0 - dropout_rate)
    return torch.matmul(probs, v)
