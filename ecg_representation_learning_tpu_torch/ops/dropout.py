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
masks from a generator on the activations' device.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from .attention import dropout_keep


@dataclasses.dataclass
class DropoutRng:
    """The generators of one training forward: ``host`` (CPU) for seeds,
    ``device`` (on the activations' device) for masks and raw bits."""
    host: torch.Generator
    device: torch.Generator

    def seed(self) -> int:
        """A non-negative 31-bit seed (the JAX ``bits >> 1``)."""
        return int(torch.randint(0, 1 << 31, (1,), generator=self.host))


def _masked(x: torch.Tensor, seed: int, rate: float, salt: int) -> torch.Tensor:
    idx = torch.arange(x.numel(), device=x.device).reshape(x.shape)
    keep = dropout_keep(seed, salt, idx, 0, rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return x * (keep.to(x.dtype) * scale)


class _HashMul(torch.autograd.Function):
    """Residual-free dropout multiply: dropout is linear in x, so the
    backward is the same masked multiply of the cotangent, with the mask
    regenerated from the seed."""

    @staticmethod
    def forward(ctx, x, seed, rate, salt):
        ctx.args = (seed, rate, salt)
        return _masked(x, seed, rate, salt)

    @staticmethod
    def backward(ctx, g):
        return _masked(g, *ctx.args), None, None, None


def hash_mul(x: torch.Tensor, seed: int, rate: float, salt: int) -> torch.Tensor:
    """The counter-hash dropout of ``x`` (the JAX ``_hash_mul``)."""
    return _HashMul.apply(x, seed, rate, salt)


class HashDropout(nn.Module):
    """Counter-hash dropout at one site; ``salt`` decorrelates the sites."""

    def __init__(self, rate: float, salt: int = 0):
        super().__init__()
        self.rate, self.salt = rate, salt

    def forward(self, x, rng: DropoutRng = None):
        if not self.training or self.rate == 0.0:
            return x
        return hash_mul(x, rng.seed(), self.rate, self.salt)


class BernoulliDropout(nn.Module):
    """flax ``nn.Dropout``: where(keep, x / (1 - rate), 0), keep ~
    Bernoulli(1 - rate) from the device generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng: DropoutRng = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            1.0 - self.rate, generator=rng.device)
        return torch.where(keep.bool(), x / (1.0 - self.rate), 0.0)


def make_dropout(impl: str, rate: float, salt: int) -> nn.Module:
    """The dropout module of one site (``VitConfig.dropout_impl``)."""
    if impl == 'hash':
        return HashDropout(rate, salt=salt)
    if impl == 'flax':
        return BernoulliDropout(rate)
    raise ValueError(f"dropout_impl must be 'flax' or 'hash', got {impl!r}")
