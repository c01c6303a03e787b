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
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

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

    def bernoulli(self, shape, p: float, device) -> torch.Tensor:
        """A Bernoulli(p) mask of ``shape`` as f32 0/1, from ``masks``."""
        return self._draw(lambda: torch.empty(shape, device=device).bernoulli_(
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


class HashDropout(nn.Module):
    """Counter-hash dropout at one site; ``salt`` decorrelates the sites."""

    def __init__(self, rate: float, salt: int = 0):
        super().__init__()
        self.rate, self.salt = rate, salt

    def forward(self, x, rng: DropoutRng = None, frame: Frame = None):
        if not self.training or self.rate == 0.0:
            return x
        return hash_mul(x, rng.seed(), self.rate, self.salt, frame)


class BernoulliDropout(nn.Module):
    """flax ``nn.Dropout``: where(keep, x / (1 - rate), 0), keep ~
    Bernoulli(1 - rate) from the device generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng: DropoutRng = None, frame: Frame = None):
        """``frame`` is not used: a Bernoulli mask has no index."""
        if not self.training or self.rate == 0.0:
            return x
        keep = rng.bernoulli(x.shape, 1.0 - self.rate, x.device)
        return torch.where(keep.bool(), x / (1.0 - self.rate), 0.0)


def make_dropout(impl: str, rate: float, salt: int) -> nn.Module:
    """The dropout module of one site (``VitConfig.dropout_impl``)."""
    if impl == 'hash':
        return HashDropout(rate, salt=salt)
    if impl == 'flax':
        return BernoulliDropout(rate)
    raise ValueError(f"dropout_impl must be 'flax' or 'hash', got {impl!r}")
