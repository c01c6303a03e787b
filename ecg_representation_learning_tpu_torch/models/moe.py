"""Switch-MoE MLP for the ViT blocks (the JAX package's ``models/moe.py``).

Every ``moe_every``-th block replaces its dense MLP with
``moe_num_experts`` expert FFNs behind a learned top-1 router.  The
semantics are the JAX package's:

  * the router is an f32 ``Linear(d, E)`` without bias; softmax, the gate is
    the top probability and the expert its argmax (the lowest index on ties,
    as ``jnp.argmax``);
  * each expert holds ``C = ceil(capacity_factor * S / E)`` tokens of the
    S = B * T in the batch, computed exactly from the decimal the user wrote
    (``Fraction(repr(cf))``); slots are handed out in token order, and a
    token past its expert's capacity contributes 0 (its block reduces to the
    residual connection);
  * the expert weights are stacked in the JAX layout: ``w1`` (E, d, f),
    ``b1`` (E, f), ``w2`` (E, f, d), ``b2`` (E, d); exact GELU; dropout on
    the expert hidden (salt 6) and on the combined output (salt 7);
  * the Switch load-balance loss ``E * sum_e(frac_e * mean_prob_e)`` is
    returned beside the output; the encoders average it over their MoE
    blocks and the trainers add ``moe_aux_weight`` times it to the objective.

JAX dispatches and combines with (S, E, C) one-hot einsums, which keep its
shapes static.  Each output of those einsums has exactly one non-zero term,
so here the tokens are copied into an (E, C, d) buffer by index, the expert
FFNs run as ``torch.bmm``, and the outputs are gathered back and scaled by
the gate: the same values without the 2 * S * E * C * d multiply-adds of
each einsum.  The shapes stay static too (a dropped token is copied to a
spare row and gathers a zero row), so the forward never waits for the
device.

On a mesh (``parallel/mesh.py``) the semantics stay those of the global
batch, as GSPMD keeps them in JAX:

  * data parallelism: S, the capacity and each token's slot are the global
    batch's -- every rank routes its rows, the data ranks' per-expert
    counts (one all-gather of E integers) give each rank the slots before
    its own, and the aux loss takes its fractions and mean probabilities
    over the global batch (sums all-reduced over 'data', with gradient).
    A rank's experts compute the global (C, d) slot buffer with only its
    own tokens' rows filled;
  * expert parallelism (``ep``, set by ``ShardedModel``): the stacks are
    sharded on E over 'model', each rank holding E / n_model experts.  The
    block's input is replicated over 'model', so every rank routes every
    token with the replicated router and runs its experts' slots; a token's
    expert output is summed over 'model' (one all-reduce: its expert is on
    one rank, the others add zeros -- a dropped token is 0 on every rank)
    and then scaled by its gate.  The aux loss comes from the replicated
    router on every rank and is never summed over 'model'.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import VitConfig
from ..ops.dropout import DropoutRng, make_dropout
from ..parallel import spmd


def moe_layer(cfg: VitConfig, i: int) -> bool:
    """Whether block ``i`` of a trunk is a MoE block (the JAX rule)."""
    return cfg.moe_num_experts > 0 and (i + 1) % cfg.moe_every == 0


def capacity(capacity_factor: float, tokens: int, experts: int) -> int:
    """Slots per expert: ceil(cf * S / E), exact for the decimal ``cf``."""
    return max(1, math.ceil(Fraction(repr(float(capacity_factor))) * tokens / experts))


class MoeMlp(nn.Module):
    """Drop-in replacement for the dense ``Mlp`` of a block; ``forward``
    returns (output, aux loss).  While ``int8`` holds (int8 stack, scales)
    pairs under ``'w1'`` / ``'w2'`` (set by ``models.quantize.int8_weights``)
    the experts compute with those stacks dequantized."""

    def __init__(self, cfg: VitConfig, dtype: torch.dtype):
        super().__init__()
        from .vit import Dense   # local: vit imports this module
        e, d, f = cfg.moe_num_experts, cfg.hidden_size, cfg.intermediate_size
        self.cfg, self.compute_dtype = cfg, dtype
        self.router = Dense(d, e, bias=False, dtype=torch.float32)
        self.w1 = nn.Parameter(torch.zeros(e, d, f))
        self.b1 = nn.Parameter(torch.zeros(e, f))
        self.w2 = nn.Parameter(torch.zeros(e, f, d))
        self.b2 = nn.Parameter(torch.zeros(e, d))
        self.drop1 = make_dropout(cfg.dropout_impl, cfg.hidden_dropout_prob, salt=6)
        self.drop2 = make_dropout(cfg.dropout_impl, cfg.hidden_dropout_prob, salt=7)
        self.int8: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.ep = False   # the expert stacks split over 'model' (expert parallelism)

    def _stack(self, name: str) -> torch.Tensor:
        if name in self.int8:
            q, s = self.int8[name]
            return q.float() * s
        return getattr(self, name)

    def route(self, xs: torch.Tensor):
        """(probs (S, E) f32, gate (S,), the (E, S) one-hot of each token's
        expert, slot (S,) or -1 when dropped, capacity) of the tokens ``xs``
        (S, d); on a mesh with several data ranks S, the capacity and the
        slots are the global batch's."""
        e = self.cfg.moe_num_experts
        s = xs.shape[0]
        probs = torch.softmax(self.router(xs.float()), dim=-1)
        gate = probs.amax(dim=-1)
        expert = probs.argmax(dim=-1)
        # (E, S): the running count runs along the contiguous token axis
        chosen = expert[None, :] == torch.arange(e, device=xs.device)[:, None]
        pos = chosen.cumsum(dim=1).gather(0, expert[None, :]).squeeze(0) - 1
        rank, n_data = spmd.data_index()
        if n_data > 1:   # the tokens of the data ranks before this one come first
            counts = spmd.data_counts(chosen.sum(dim=1))          # (n_data, E)
            pos = pos + counts[:rank].sum(dim=0).index_select(0, expert)
        cap = capacity(self.cfg.moe_capacity_factor, s * n_data, e)
        slot = torch.where(pos < cap, expert * cap + pos, -1)
        return probs, gate, chosen, slot, cap

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRng] = None):
        cfg, dt = self.cfg, self.compute_dtype
        e = cfg.moe_num_experts
        b, t, d = x.shape
        xs = x.reshape(b * t, d)
        probs, gate, chosen, slot, cap = self.route(xs)
        if spmd.data_index()[1] == 1:
            frac = chosen.float().mean(dim=1)
            aux = e * torch.sum(frac * probs.mean(dim=0))
        else:            # over the global batch
            n_tok = xs.shape[0] * spmd.data_index()[1]
            frac = spmd.mean_over_data(chosen.float().mean(dim=1))
            aux = e * torch.sum(frac * (spmd.all_reduce_data(probs.sum(dim=0)) / n_tok))

        # every shape is known on the host: a dropped token (or, under
        # expert parallelism, one of another rank's experts) goes to a spare
        # row, which the experts never read, and reads back zeros
        e0, e_loc = spmd.model_slice(e) if self.ep else (0, e)
        local = (slot >= e0 * cap) & (slot < (e0 + e_loc) * cap)
        dest = torch.where(local, slot - e0 * cap, e_loc * cap)
        xin = spmd.copy_to_model(xs) if self.ep else xs
        xe = xs.new_zeros((e_loc * cap + 1, d), dtype=dt).index_copy(0, dest, xin.to(dt))
        h = torch.bmm(xe[:-1].reshape(e_loc, cap, d), self._stack('w1').to(dt))
        h = F.gelu(h + self.b1[:, None, :].to(dt), approximate='none')
        h = self.drop1(h, rng, spmd.frame(h.shape, batch_dim=None,
                                          model_dim=0 if self.ep else None))
        ye = torch.bmm(h, self._stack('w2').to(dt)) + self.b2[:, None, :].to(dt)
        ye = torch.cat([ye.reshape(e_loc * cap, d), ye.new_zeros((1, d))])
        yt = ye.index_select(0, dest)
        if self.ep:
            yt = spmd.reduce_from_model(yt)
        ys = yt * gate.to(dt)[:, None]
        return self.drop2(ys, rng, spmd.frame(ys.shape)).reshape(b, t, d), aux


def mean_aux(auxes, device) -> torch.Tensor:
    """The mean of the MoE blocks' aux losses (the JAX ``moe_aux_loss``);
    an f32 0 on ``device`` when there are none."""
    return sum(auxes) / len(auxes) if auxes else torch.zeros((), device=device)
