"""Training dropout: the counter-hash mask and flax's Bernoulli mask.

Counterpart of the JAX package's ``ops/dropout.py`` and of the dropout
sites of its ``models/vit.py``.  ``VitConfig.dropout_impl`` picks the mask:

  * ``'hash'``: :class:`HashDropout`, keep iff the low 24 bits of
    ``dropout_keep(seed, salt, flat index, 0)`` clear the rate's threshold --
    bit-equal to the JAX ``_masked`` for the same seed and salt.  Its backward
    regenerates the mask from the seed instead of saving it (``_hash_mul``,
    the JAX ``custom_vjp``).
  * ``'flax'``: :class:`BernoulliDropout`, flax ``nn.Dropout``'s semantics
    (keep with probability 1 - rate, kept values divided by 1 - rate) with the
    mask drawn from the trainer's device generator.  flax's bits come from
    JAX's rbg streams and cannot be matched; only the distribution is held.

A site of the ViT block is applied with its neighbour (:class:`_Site`):
``gelu(a)`` is dropout of the exact GELU of ``a`` (the MLP hidden),
``add_to(x, y)`` is ``x`` plus dropout of ``y`` (the attention and MLP
outputs).  A Bernoulli site in training at a rate above 0 draws its mask as
``forward`` would (bool on the card) and on the card runs one kernel of
``csrc/dropout_sites.cu`` each way (:func:`gelu_dropout`,
:func:`dropout_add`: the mask, the scale and the GELU or the add in one
pass, rounding where the chain of PyTorch kernels rounds); on the CPU the
plain versions, which are that chain.  Other sites run ``forward`` and then
their operation.

A training forward draws its randomness from a :class:`DropoutRng`: 31-bit
seeds for the hashed masks (this module's and the attention kernel's) from a
host generator, so drawing one never waits for the device, and Bernoulli
masks from a generator on the activations' device.  A step run from a tape
(``train/dispatch.py``: several steps, or a CUDA graph, per dispatch) takes
its seeds from the tape instead: ``DropoutRng.tape`` holds the step's seeds,
drawn ahead from the same host generator in the same order, as 0-d int32
tensors on the device (or ints), and ``seed()`` hands them out in turn.

On a mesh (``parallel/``) a rank holds a slice of each activation.  A hashed
mask is a function of the element's index in the GLOBAL array, so a rank
passes ``frame`` -- where its slice sits, ``parallel.spmd.frame`` -- and
draws the global array's mask for its elements, as GSPMD does in JAX.
Bernoulli masks come from ``DropoutRng.mask``, a generator seeded per data
rank, so ranks draw decorrelated masks (the JAX masks are held by their
distribution only); every rank of one model group draws the same ones.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import _build
from .attention import dropout_keep, raw_bits


@dataclasses.dataclass
class DropoutRng:
    """The generators of one training forward: ``host`` (CPU) for seeds,
    ``device`` (on the activations' device) for masks, raw bits and the
    draws made for the whole batch; ``mask``, when set (a mesh with more
    than one data rank), for Bernoulli masks and raw bits instead.

    ``tape``, while set, is the running step's seeds (a 1-D int32 tensor on
    the device, or a list of ints) and ``cursor`` the next one to hand out.
    ``saved`` and ``replay`` serve a remat block under a tape
    (``models/vit._replaying``): the block's first run appends each mask and
    raw-bit draw to ``saved``, and its recompute takes them back in order
    from index ``replay``, since a generator's state cannot be read or set
    inside a CUDA graph capture."""
    host: torch.Generator
    device: torch.Generator
    mask: Optional[torch.Generator] = None
    tape: Optional[Sequence] = dataclasses.field(default=None, repr=False)
    cursor: int = 0
    saved: Optional[List[torch.Tensor]] = dataclasses.field(default=None, repr=False)
    replay: Optional[int] = None

    @property
    def masks(self) -> torch.Generator:
        """The generator of Bernoulli masks and raw dropout bits."""
        return self.device if self.mask is None else self.mask

    @contextlib.contextmanager
    def taped(self, seeds: Sequence):
        """``seed()`` hands out ``seeds`` in turn for the duration (a step of
        a step tape), and the step must take every one of them."""
        self.tape, self.cursor = seeds, 0
        try:
            yield
        finally:
            self.tape = None
        if self.cursor != len(seeds):
            raise RuntimeError(f'a step took {self.cursor} dropout seeds, the tape holds '
                               f'{len(seeds)}')

    def seed(self):
        """A non-negative 31-bit seed (the JAX ``bits >> 1``): an int from
        the host generator, or the tape's next slot."""
        if self.tape is not None:
            self.cursor += 1
            return self.tape[self.cursor - 1]
        return int(torch.randint(0, 1 << 31, (1,), generator=self.host))

    def _draw(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        if self.replay is not None:
            self.replay += 1
            return self.saved[self.replay - 1]
        out = fn()
        if self.saved is not None:
            self.saved.append(out)
        return out

    def bernoulli(self, shape, p: float, device, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
        """A Bernoulli(p) mask of ``shape`` as 0/1 of ``dtype``, from ``masks``.
        On the card a bool draw keeps the bits of the f32 one, and moves the
        generator as far (``tests/test_torch_dropout_card.py``)."""
        return self._draw(lambda: torch.empty(shape, dtype=dtype, device=device).bernoulli_(
            p, generator=self.masks))

    def bits(self, shape, device) -> torch.Tensor:
        """Raw 32-bit draws (int64) of ``shape``, from ``masks``."""
        return self._draw(lambda: raw_bits(shape, device, generator=self.masks))


Frame = Optional[Dict[int, Tuple[int, int]]]


def flat_index(shape, frame: Frame, device) -> torch.Tensor:
    """Each element's row-major index: in the tensor itself (``frame``
    None), or in the global array where dim d of this slice starts at
    ``frame[d][0]`` of ``frame[d][1]`` (other dims whole); ``frame[d][0]``
    may also be a tensor of the slice's ``shape[d]`` global indices along d
    (rows that are not contiguous, as a pipeline's data rank holds)."""
    if not frame:
        return torch.arange(math.prod(shape), device=device).reshape(shape)
    idx = torch.zeros((1,) * len(shape), dtype=torch.int64, device=device)
    for d, n in enumerate(shape):
        off, total = frame.get(d, (0, n))
        view = [1] * len(shape)
        view[d] = n
        pos = (off.to(device=device, dtype=torch.int64) if isinstance(off, torch.Tensor)
               else torch.arange(n, device=device) + off)
        idx = idx * total + pos.reshape(view)
    return idx.expand(*shape)


def _masked(x: torch.Tensor, seed, rate: float, salt: int,
            frame: Frame = None) -> torch.Tensor:
    idx = flat_index(tuple(x.shape), frame, x.device)
    keep = dropout_keep(seed, salt, idx, 0, rate)
    # a fill, not a host copy, so that a CUDA graph can capture it
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return x * (keep.to(x.dtype) * scale)


class _HashMul(torch.autograd.Function):
    """Residual-free dropout multiply: dropout is linear in x, so the
    backward is the same masked multiply of the cotangent, with the mask
    regenerated from the seed."""

    @staticmethod
    def forward(ctx, x, seed, rate, salt, frame):
        ctx.args = (seed, rate, salt, frame)
        return _masked(x, seed, rate, salt, frame)

    @staticmethod
    def backward(ctx, g):
        return _masked(g, *ctx.args), None, None, None, None


def hash_mul(x: torch.Tensor, seed, rate: float, salt: int,
             frame: Frame = None) -> torch.Tensor:
    """The counter-hash dropout of ``x`` (the JAX ``_hash_mul``); ``seed`` is
    an int or a 0-d int32 tensor; ``frame`` places ``x`` in a global array
    (see :func:`flat_index`)."""
    return _HashMul.apply(x, seed, rate, salt, frame)


def keep_scale(rate: float) -> float:
    """The factor by which PyTorch's ``x / (1 - rate)`` multiplies on the
    card: the f32 reciprocal of the f32 ``1 - rate``."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def gelu_dropout_reference(a: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Plain version of the MLP hidden site: flax dropout of the exact GELU
    of ``a`` with the drawn mask ``keep`` (f32 0/1 or bool)."""
    return torch.where(keep.bool(), F.gelu(a, approximate='none') / (1.0 - rate), 0.0)


def dropout_add_reference(x: torch.Tensor, y: torch.Tensor, keep: torch.Tensor,
                          rate: float) -> torch.Tensor:
    """Plain version of an output site: the residual ``x`` plus flax dropout
    of the branch ``y`` with the drawn mask ``keep``."""
    return x + torch.where(keep.bool(), y / (1.0 - rate), 0.0)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = {'gelu_dropout_forward': [_P] * 3 + [_L, _I, _F, _P],
         'gelu_dropout_backward': [_P] * 4 + [_L, _I, _F, _P],
         'dropout_add_forward': [_P] * 4 + [_L, _I, _I, _F, _P],
         'dropout_add_backward': [_P] * 3 + [_L, _I, _I, _F, _P]}


def _launch(kernel: _build.CtypesKernel, direction: str, out: torch.Tensor,
            tensors: Sequence[torch.Tensor], codes: Sequence[int], inv: float) -> torch.Tensor:
    """``out`` from ``tensors`` (the bool mask second, as every entry takes
    it) in one launch of ``kernel``; every tensor contiguous, of ``out``'s
    shape, on its CUDA device."""
    dev, shape = out.get_device(), out.shape
    for t in (*tensors, out):
        if t.get_device() != dev or t.shape != shape or not t.is_contiguous():
            raise ValueError(f'{kernel.kind}: every tensor must be contiguous, '
                             f'{tuple(shape)}, on {out.device}; got {tuple(t.shape)} '
                             f'on {t.device}')
    if dev < 0 or tensors[1].dtype != torch.bool:
        raise ValueError(f'{kernel.kind} kernel takes CUDA tensors and a bool mask, got '
                         f'{out.device} and {tensors[1].dtype}')
    kernel.launch(direction, out.device, (*[t.data_ptr() for t in tensors], out.data_ptr(),
                                          out.numel(), *codes, inv))
    return out


# ``csrc/dropout_sites.cu``'s entries of each site kind, with their launch
# counts (the eager step makes 72 launches)
gelu_dropout_kernel = _build.CtypesKernel('dropout_sites', 'gelu_dropout', _ARGS)
dropout_add_kernel = _build.CtypesKernel('dropout_sites', 'dropout_add', _ARGS)


def _code(t: torch.Tensor) -> int:
    if t.dtype not in _CODES:
        raise TypeError(f'the dropout site kernels take float32 or bfloat16, got {t.dtype}')
    return _CODES[t.dtype]


class _GeluDropout(torch.autograd.Function):
    """The MLP hidden site on the card: one launch each way; saves ``a``
    and the mask, as the chain's GELU and ``where`` did."""

    @staticmethod
    def forward(ctx, a, keep, rate):
        a, keep = a.contiguous(), keep.contiguous()
        ctx.save_for_backward(a, keep)
        ctx.inv = keep_scale(rate)
        return _launch(gelu_dropout_kernel, 'forward', torch.empty_like(a), (a, keep),
                       (_code(a),), ctx.inv)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, keep = ctx.saved_tensors
        return _launch(gelu_dropout_kernel, 'backward', torch.empty_like(a),
                       (g.contiguous().to(a.dtype), keep, a), (_code(a),), ctx.inv), None, None


class _DropoutAdd(torch.autograd.Function):
    """An output site on the card: one launch each way; the gradient of the
    residual is the incoming one, as the chain's add passed it on."""

    @staticmethod
    def forward(ctx, x, y, keep, rate):
        x, y, keep = x.contiguous(), y.contiguous(), keep.contiguous()
        ctx.save_for_backward(keep)
        ctx.inv, ctx.y_dtype = keep_scale(rate), y.dtype
        out = torch.empty_like(y, dtype=torch.promote_types(x.dtype, y.dtype))
        return _launch(dropout_add_kernel, 'forward', out, (y, keep, x), (_code(y), _code(x)),
                       ctx.inv)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        keep, = ctx.saved_tensors
        dy = None
        if ctx.needs_input_grad[1]:
            g = g.contiguous()
            dy = _launch(dropout_add_kernel, 'backward', torch.empty_like(g, dtype=ctx.y_dtype),
                         (g, keep), (_code(g), _CODES[ctx.y_dtype]), ctx.inv)
        return g if ctx.needs_input_grad[0] else None, dy, None, None


def gelu_dropout(a: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """where(keep, gelu(a) / (1 - rate), 0) with its gradient: on the card
    one kernel launch each way (``keep`` bool), on the CPU the plain
    version."""
    if a.device.type == 'cuda':
        return _GeluDropout.apply(a, keep, rate)
    return gelu_dropout_reference(a, keep, rate)


def dropout_add(x: torch.Tensor, y: torch.Tensor, keep: torch.Tensor,
                rate: float) -> torch.Tensor:
    """x + where(keep, y / (1 - rate), 0) with its gradients: on the card
    one kernel launch each way (``keep`` bool), on the CPU the plain
    version."""
    if y.device.type == 'cuda':
        return _DropoutAdd.apply(x, y, keep, rate)
    return dropout_add_reference(x, y, keep, rate)


class _Site(nn.Module):
    """A dropout site of the block, with the elementwise operation beside it:
    ``gelu`` (the MLP hidden) and ``add_to`` (an output and its residual)."""

    def gelu(self, a, rng: DropoutRng = None, frame: Frame = None):
        """Dropout of the exact GELU of ``a``."""
        return self(F.gelu(a, approximate='none'), rng, frame)

    def add_to(self, x, y, rng: DropoutRng = None, frame: Frame = None):
        """``x`` plus dropout of ``y``."""
        return x + self(y, rng, frame)


class HashDropout(_Site):
    """Counter-hash dropout at one site; ``salt`` decorrelates the sites."""

    def __init__(self, rate: float, salt: int = 0):
        super().__init__()
        self.rate, self.salt = rate, salt

    def forward(self, x, rng: DropoutRng = None, frame: Frame = None):
        if not self.training or self.rate == 0.0:
            return x
        return hash_mul(x, rng.seed(), self.rate, self.salt, frame)


class BernoulliDropout(_Site):
    """flax ``nn.Dropout``: where(keep, x / (1 - rate), 0), keep ~
    Bernoulli(1 - rate) from the device generator.  In training at a rate
    above 0, ``gelu`` and ``add_to`` draw the site's mask as ``forward``
    does and apply it with their operation in one kernel on the card
    (:func:`gelu_dropout`, :func:`dropout_add`; the mask drawn as bool)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng: DropoutRng = None, frame: Frame = None):
        """``frame`` is not used: a Bernoulli mask has no index."""
        if not self.training or self.rate == 0.0:
            return x
        keep = rng.bernoulli(x.shape, 1.0 - self.rate, x.device)
        return torch.where(keep.bool(), x / (1.0 - self.rate), 0.0)

    def _keep(self, x, rng: DropoutRng) -> torch.Tensor:
        dtype = torch.bool if x.device.type == 'cuda' else torch.float32
        return rng.bernoulli(x.shape, 1.0 - self.rate, x.device, dtype=dtype)

    def gelu(self, a, rng: DropoutRng = None, frame: Frame = None):
        if not self.training or self.rate == 0.0:
            return super().gelu(a, rng, frame)
        return gelu_dropout(a, self._keep(a, rng), self.rate)

    def add_to(self, x, y, rng: DropoutRng = None, frame: Frame = None):
        if not self.training or self.rate == 0.0:
            return super().add_to(x, y, rng, frame)
        return dropout_add(x, y, self._keep(y, rng), self.rate)


def make_dropout(impl: str, rate: float, salt: int) -> nn.Module:
    """The dropout module of one site (``VitConfig.dropout_impl``)."""
    if impl == 'hash':
        return HashDropout(rate, salt=salt)
    if impl == 'flax':
        return BernoulliDropout(rate)
    raise ValueError(f"dropout_impl must be 'flax' or 'hash', got {impl!r}")
