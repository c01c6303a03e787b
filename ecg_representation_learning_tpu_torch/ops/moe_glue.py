"""The glue of the DeepSeek MoE layer (``models/moe.py``'s ``DeepseekMoe``):
the passes that move rows between the router and the output, and the
SwiGLU between the held experts' grouped GEMMs, forward and backward.

The layer sorts its (token, choice) pairs by held expert into a static buffer
of ``rows`` = T * min(k, held experts) rows, of which the first ``offs[-1]``
(the last of the grouped GEMMs' row ends, on the device) are routed to the
held experts.  Each operation reads and writes only those rows, and leaves
the rest of the buffer as it was allocated:

  * :func:`permute`: ``xp[i]`` = ``xs[order[i] // k]`` cast to the experts'
    type; its gradient sums each token's held choices' rows of the incoming
    gradient in f32, in choice order;
  * :func:`swiglu`: ``silu(h[:, :f]) * h[:, f:]``, and its gradient;
  * :func:`combine`: the f32 sum over each token's held choices of its gate
    times its expert output row; its gradient gives each held gate the dot
    product of its row with the token's gradient, and each held row its
    gate times the token's gradient, cast to the rows' type.

On the card each direction of each operation is one launch of
``csrc/moe_glue.cu`` (kernel #9), which loads the count from ``offs`` on
the device: no host read, so a CUDA graph captures the layer.  The kernels
move rows in 16-byte vectors only: on the card every row tensor must start on
16 bytes and be a multiple of ``ROW_STEP`` wide, and the wrappers raise
ValueError for anything else (the layer passes fresh tensors of its widths,
2,048 and 1,408 in Moonlight's block).  On the CPU
each runs its plain version (``*_reference``): the chain of PyTorch
operations the layer ran before the kernels, with the rows past the count
of each buffer output set to NaN, so that a test sees any use of them.  The
kernels round where those chains round (``csrc/moe_glue.cu``); only the
gates' dot products sum in another order.  Each launch counts under its
operation's name in ``_build``'s registry (``moe_permute``,
``moe_permute_bwd``, ...).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

MAX_TOP_K = 8   # choices a token may make on the card (``kMaxK``)
ROW_STEP = 8    # a row's width on the card is a multiple of this (``kVec``)
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = {'moe_permute_forward': [_P] * 3 + [_I, _P, _L, _L, _I, _I, _I, _P],
         'moe_permute_backward': [_P] * 4 + [_L, _L, _I, _I, _P],
         'moe_swiglu_forward': [_P, _P, _I, _P, _L, _L, _I, _P],
         'moe_swiglu_backward': [_P] * 3 + [_I, _P, _L, _L, _I, _P],
         'moe_combine_forward': [_P] * 5 + [_L, _L, _I, _I, _P],
         'moe_combine_backward': [_P] * 7 + [_I, _P, _P, _L, _L, _L, _I, _I, _P]}
# ``csrc/moe_glue.cu``'s forward and backward entries of each operation
GLUE = _build.CtypesLibrary('moe_glue', _ARGS)

_FLOATS = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)
_I64 = (torch.int64,)
_BOOL = (torch.bool,)


def _checked(entry: str, *specs) -> bool:
    """Raise ValueError unless every (name, tensor, shape, dtypes) of
    ``specs`` is contiguous, of its shape and one of its dtypes, and all lie
    on one device; True when that device is a card."""
    device = specs[0][1].device
    for name, t, shape, dtypes in specs:
        if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f'{entry}: {name} must be a contiguous {tuple(shape)} tensor of '
                             f'{" or ".join(map(str, dtypes))}; got {tuple(t.shape)} '
                             f'{t.dtype}{"" if t.is_contiguous() else ", not contiguous"}')
        if t.device != device:
            raise ValueError(f'{entry}: {name} is on {t.device}, the others on {device}')
    return device.type == 'cuda'


def _offs(offs: torch.Tensor):
    """The check of ``offs``: 1-D int32 or int64 row ends, at least one."""
    return ('offs', offs, (max(offs.shape[0], 1) if offs.dim() else 1,),
            (torch.int32, torch.int64))


def _count_args(offs: torch.Tensor) -> Tuple[int, int]:
    """The device address of the count (offs[-1]) and whether it is int64."""
    return offs[-1:].data_ptr(), int(offs.dtype == torch.int64)


def _card(entry: str, rows: Sequence[Tuple[str, torch.Tensor]], k: int = 1,
          buffer_rows: int = 0) -> None:
    """Raise ValueError for what the kernel does not take: more than
    ``MAX_TOP_K`` choices a token, a buffer row index past int32, or a
    tensor of ``rows`` (name, tensor) whose width is not a multiple of
    ``ROW_STEP`` or whose first row does not start on 16 bytes (the kernel
    moves rows in 16-byte steps)."""
    if not 1 <= k <= MAX_TOP_K:
        raise ValueError(f'{entry}: the kernel takes 1 to {MAX_TOP_K} choices a token, got {k}')
    if buffer_rows >= 1 << 31:
        raise ValueError(f'{entry}: the kernel takes fewer than 2**31 buffer rows, '
                         f'got {buffer_rows}')
    for name, t in rows:
        if t.shape[-1] % ROW_STEP or t.data_ptr() % 16:
            raise ValueError(f'{entry}: the kernel takes rows {ROW_STEP}k wide starting on 16 '
                             f'bytes; {name} is {t.shape[-1]} wide at address '
                             f'{t.data_ptr():#x}')


def _half(entry: str, h: torch.Tensor) -> int:
    """f of ``h`` (rows, 2f): the width of each half."""
    if h.shape[-1] % 2:
        raise ValueError(f'{entry}: h must hold two halves of one width; got {tuple(h.shape)}')
    return h.shape[-1] // 2


def _past_count_nan(out: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``out`` with its rows at or past offs[-1] set to NaN (no host read)."""
    keep = torch.arange(out.shape[0], device=out.device) < offs[-1]
    return torch.where(keep[:, None], out, torch.full((), float('nan'), dtype=out.dtype,
                                                      device=out.device))


# ------------------------------------------------------------ plain versions
def permute_forward_reference(xs: torch.Tensor, order: torch.Tensor, offs: torch.Tensor,
                              rows: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`permute_forward`."""
    k = order.shape[0] // xs.shape[0]
    return _past_count_nan(xs.to(dtype).index_select(0, order[:rows] // k), offs)


def permute_backward_reference(g: torch.Tensor, pos: torch.Tensor,
                               held: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`permute_backward`."""
    gx = torch.zeros((pos.shape[0], g.shape[1]), dtype=torch.float32, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for j in range(pos.shape[1]):
        gx += torch.where(held[:, j, None], g.index_select(0, pos[:, j]), zero)
    return gx


def swiglu_forward_reference(h: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`swiglu_forward`."""
    f = h.shape[1] // 2
    return _past_count_nan(F.silu(h[:, :f]) * h[:, f:], offs)


def swiglu_backward_reference(h: torch.Tensor, da: torch.Tensor,
                              offs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`swiglu_backward`: autograd's gradients of the
    forward's product and silu."""
    f = h.shape[1] // 2
    gate, up = h[:, :f], h[:, f:]
    dgate = torch.ops.aten.silu_backward(da * up, gate)
    return _past_count_nan(torch.cat([dgate, da * F.silu(gate)], dim=1), offs)


def _valid_rows(y: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``y`` with the rows past the count zeroed, so that no product reads them."""
    valid = torch.arange(y.shape[0], device=y.device) < offs[-1]
    return torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))


def combine_forward_reference(y: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor,
                              held: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`combine_forward`."""
    yc = _valid_rows(y, offs)
    w = torch.where(held, gates, torch.zeros((), device=gates.device))
    out = torch.zeros((pos.shape[0], y.shape[1]), dtype=torch.float32, device=y.device)
    for j in range(pos.shape[1]):
        out.addcmul_(yc.index_select(0, pos[:, j]), w[:, j, None])
    return out


def combine_backward_reference(y: torch.Tensor, gates: torch.Tensor, dout: torch.Tensor,
                               pos: torch.Tensor, held: torch.Tensor, order: torch.Tensor,
                               offs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`combine_backward`."""
    yc = _valid_rows(y, offs)
    k = pos.shape[1]
    zero = torch.zeros((), device=gates.device)
    dgates = torch.stack([(yc.index_select(0, pos[:, j]) * dout).sum(dim=-1)
                          for j in range(k)], dim=1)
    w = torch.where(held, gates, zero)
    src = order[:y.shape[0]]
    dy = dout.index_select(0, src // k) * w.reshape(-1).index_select(0, src)[:, None]
    return _past_count_nan(dy.to(y.dtype), offs), torch.where(held, dgates, zero)


# ------------------------------------------------------------------ entries
def permute_forward(xs: torch.Tensor, order: torch.Tensor, offs: torch.Tensor, rows: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """The buffer (``rows``, d) of ``dtype``: row i < offs[-1] is token
    ``order[i] // k`` of ``xs`` (T, d) cast, k = len(order) / T."""
    s, d = xs.shape[0], xs.shape[-1]
    k = order.shape[0] // max(s, 1)
    if dtype not in _FLOATS:
        raise ValueError(f'permute_forward: dtype must be float32 or bfloat16, got {dtype}')
    if not _checked('permute_forward', ('xs', xs, (s, d), _FLOATS),
                    ('order', order, (s * k,), _I64), _offs(offs)):
        return permute_forward_reference(xs, order, offs, rows, dtype)
    _card('permute_forward', [('xs', xs)], k, rows)
    xp = torch.empty((rows, d), dtype=dtype, device=xs.device)
    GLUE.launch('moe_permute_forward', 'moe_permute', xs.device, (
        xs.data_ptr(), order.data_ptr(), *_count_args(offs), xp.data_ptr(), rows, d, k,
        _CODES[xs.dtype], _CODES[dtype]))
    return xp


def permute_backward(g: torch.Tensor, pos: torch.Tensor, held: torch.Tensor) -> torch.Tensor:
    """(T, d) f32: each token's sum of the rows of ``g`` (rows, d) at its held
    choices ``pos[s, j]`` (``held`` (T, k)), in choice order."""
    s, k = pos.shape[0], pos.shape[-1]
    if not _checked('permute_backward', ('g', g, (g.shape[0], g.shape[-1]), _FLOATS),
                    ('pos', pos, (s, k), _I64), ('held', held, (s, k), _BOOL)):
        return permute_backward_reference(g, pos, held)
    d = g.shape[1]
    _card('permute_backward', [('g', g)], k, g.shape[0])
    gx = torch.empty((s, d), dtype=torch.float32, device=g.device)
    GLUE.launch('moe_permute_backward', 'moe_permute_bwd', g.device, (
        g.data_ptr(), pos.data_ptr(), held.data_ptr(), gx.data_ptr(), s, d, k, _CODES[g.dtype]))
    return gx


def swiglu_forward(h: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(rows, f): silu(h[:, :f]) * h[:, f:] of ``h`` (rows, 2f), rows < offs[-1]."""
    rows, f = h.shape[0], _half('swiglu_forward', h)
    if not _checked('swiglu_forward', ('h', h, (rows, 2 * f), _FLOATS), _offs(offs)):
        return swiglu_forward_reference(h, offs)
    _card('swiglu_forward', [('h', h), ('h[:, f:]', h[:, f:])])
    a = torch.empty((rows, f), dtype=h.dtype, device=h.device)
    GLUE.launch('moe_swiglu_forward', 'moe_swiglu', h.device, (
        h.data_ptr(), *_count_args(offs), a.data_ptr(), rows, f, _CODES[h.dtype]))
    return a


def swiglu_backward(h: torch.Tensor, da: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(rows, 2f): the gradient of :func:`swiglu_forward` with respect to
    ``h``, from ``da`` (rows, f), rows < offs[-1]."""
    rows, f = h.shape[0], _half('swiglu_backward', h)
    if not _checked('swiglu_backward', ('h', h, (rows, 2 * f), _FLOATS),
                    ('da', da, (rows, f), (h.dtype,)), _offs(offs)):
        return swiglu_backward_reference(h, da, offs)
    _card('swiglu_backward', [('h', h), ('h[:, f:]', h[:, f:]), ('da', da)])
    dh = torch.empty_like(h)
    GLUE.launch('moe_swiglu_backward', 'moe_swiglu_bwd', h.device, (
        h.data_ptr(), da.data_ptr(), *_count_args(offs), dh.data_ptr(), rows, f,
        _CODES[h.dtype]))
    return dh


def combine_forward(y: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor,
                    held: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(T, d) f32: each token's sum over its held choices j, in order, of
    ``gates[s, j]`` times row ``pos[s, j]`` of ``y`` (rows, d)."""
    s, k = pos.shape[0], pos.shape[-1]
    if not _checked('combine_forward', ('y', y, (y.shape[0], y.shape[-1]), _FLOATS),
                    ('gates', gates, (s, k), _F32), ('pos', pos, (s, k), _I64),
                    ('held', held, (s, k), _BOOL), _offs(offs)):
        return combine_forward_reference(y, gates, pos, held, offs)
    d = y.shape[1]
    _card('combine_forward', [('y', y)], k, y.shape[0])
    out = torch.empty((s, d), dtype=torch.float32, device=y.device)
    GLUE.launch('moe_combine_forward', 'moe_combine', y.device, (
        y.data_ptr(), gates.data_ptr(), pos.data_ptr(), held.data_ptr(), out.data_ptr(), s, d,
        k, _CODES[y.dtype]))
    return out


def combine_backward(y: torch.Tensor, gates: torch.Tensor, dout: torch.Tensor,
                     pos: torch.Tensor, held: torch.Tensor, order: torch.Tensor,
                     offs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy (rows, d) of y's type, dgates (T, k) f32) from ``dout`` (T, d) f32:
    row i < offs[-1] of dy is its pair's gate times its token's ``dout``
    (``order``: the pair of each row); a held gate's gradient is the dot
    product of its row of ``y`` with its token's ``dout``, any other 0."""
    s, k = pos.shape[0], pos.shape[-1]
    rows, d = y.shape[0], y.shape[-1]
    if not _checked('combine_backward', ('y', y, (rows, d), _FLOATS),
                    ('gates', gates, (s, k), _F32), ('dout', dout, (s, d), _F32),
                    ('pos', pos, (s, k), _I64), ('held', held, (s, k), _BOOL),
                    ('order', order, (s * k,), _I64), _offs(offs)):
        return combine_backward_reference(y, gates, dout, pos, held, order, offs)
    _card('combine_backward', [('y', y), ('dout', dout)], k, rows)
    dy = torch.empty_like(y)
    dgates = torch.empty((s, k), dtype=torch.float32, device=y.device)
    GLUE.launch('moe_combine_backward', 'moe_combine_bwd', y.device, (
        y.data_ptr(), gates.data_ptr(), dout.data_ptr(), pos.data_ptr(), held.data_ptr(),
        order.data_ptr(), *_count_args(offs), dgates.data_ptr(), dy.data_ptr(), s, rows, d, k,
        _CODES[y.dtype]))
    return dy, dgates


# ----------------------------------------------------------------- autograd
class _Permute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, order, pos, held, offs, rows, dtype):
        ctx.save_for_backward(pos, held)
        return permute_forward(xs, order, offs, rows, dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pos, held = ctx.saved_tensors
        return permute_backward(g.contiguous(), pos, held), None, None, None, None, None, None


class _Swiglu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, offs):
        ctx.save_for_backward(h, offs)
        return swiglu_forward(h, offs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, da):
        h, offs = ctx.saved_tensors
        return swiglu_backward(h, da.contiguous(), offs), None


class _Combine(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, gates, pos, held, order, offs):
        ctx.save_for_backward(y, gates, pos, held, order, offs)
        return combine_forward(y, gates, pos, held, offs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        y, gates, pos, held, order, offs = ctx.saved_tensors
        dy, dgates = combine_backward(y, gates, dout.contiguous(), pos, held, order, offs)
        return dy, dgates, None, None, None, None


def permute(xs: torch.Tensor, order: torch.Tensor, pos: torch.Tensor, held: torch.Tensor,
            offs: torch.Tensor, rows: int, dtype: torch.dtype) -> torch.Tensor:
    """:func:`permute_forward` with its gradient (:func:`permute_backward`);
    ``pos`` (T, k): the buffer row of each pair, ``held``: whether it is
    routed to a held expert."""
    return _Permute.apply(xs, order, pos, held, offs, rows, dtype)


def swiglu(h: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """:func:`swiglu_forward` with its gradient (:func:`swiglu_backward`)."""
    return _Swiglu.apply(h, offs)


def combine(y: torch.Tensor, gates: torch.Tensor, pos: torch.Tensor, held: torch.Tensor,
            order: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """:func:`combine_forward` with its gradients (:func:`combine_backward`)."""
    return _Combine.apply(y, gates, pos, held, order, offs)
