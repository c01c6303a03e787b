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

``DeepseekMoe`` is DeepSeek-V3's MoE layer (``VitConfig.block ==
'deepseek'``), dropless, on one device's share of the routed experts:

  * s = sigmoid(x W_r) in f32 over all ``moe_num_experts``; the experts are
    the top ``moe_top_k`` of s + b, b the correction bias (a buffer, moved
    by the trainer's aux-loss-free update, never by a gradient); the gates
    are s at the chosen experts over their sum (+1e-20), times
    ``moe_routed_scale`` (``noaux_tc`` with one group);
  * the output is the sum of the held experts' gated SwiGLU outputs plus the
    shared experts' SwiGLU (``moe_shared_experts`` experts as one of that
    many times the width).  The layer holds experts ``moe_held`` = (first,
    count), routes over all of them and computes only its held experts'
    part: no exchange, nothing for the absent devices;
  * dropless with static shapes: the (token, choice) pairs are sorted by held
    expert on the device (the others after them), and the held experts run
    as grouped GEMMs over device-side offsets (``torch._grouped_mm`` for bf16
    on the GPU) on a buffer of T * min(k, count) rows, the most a token set
    can route here.  The row gather into the buffer, the SwiGLU between
    the GEMMs and the gated sum back, each way, are ``ops/moe_glue.py``
    (one launch of kernel #9 each on the card), which touch only the rows
    below the last offset: rows past it are never written, and neither they
    nor their gradients reach the output or the inputs.  No host read, so
    the step captures in a CUDA graph;
  * the sequence-wise balance loss of DeepSeek-V3 (a sequence is a record):
    mean over records of sum_i f_i P_i, with f_i = E / (k T) times the
    record's choices of expert i and P_i the record's mean of s_i / sum_j s_j,
    returned beside the output; the counts of every expert's choices are
    added into the ``load`` buffer for the trainer's bias update, and the
    held rows and the busiest held expert's rows into two running device
    counters (``routed_counters``).
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import VitConfig
from ..ops import moe_glue
from ..ops.dropout import DropoutRng, make_dropout
from ..parallel import spmd


def moe_layer(cfg: VitConfig, i: int) -> bool:
    """Whether block ``i`` of a trunk is a MoE block (the JAX rule; for the
    deepseek and afmoe blocks every block from ``first_k_dense_replace`` on)."""
    if cfg.block in ('deepseek', 'afmoe'):
        return cfg.moe_num_experts > 0 and i >= cfg.first_k_dense_replace
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


# ---------------------------------------------------------------- DeepSeek-V3
def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(R, N): rows offs[g-1]:offs[g] of ``a`` (R, K) times ``w[g]``.T, ``w``
    (G, N, K) in ``nn.Linear``'s layout, ``offs`` (G,) int32 cumulative row
    ends.  Rows past offs[-1] are left as they are allocated: bf16 on the
    GPU runs ``torch._grouped_mm`` (no host read); otherwise each group is
    one product, its bounds read on the host, and the rows past the last
    offset are NaN, so a test sees any use of them."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, w.transpose(-2, -1), offs=offs)
    out = a.new_full((a.shape[0], w.shape[1]), float('nan'))
    lo = 0
    for g, hi in enumerate(offs.tolist()):
        out[lo:hi] = a[lo:hi] @ w[g].t()
        lo = hi
    return out


def sort_pairs(idx: torch.Tensor, first: int, n_held: int, rows: int):
    """The (token, choice) pairs of the choices ``idx`` (T, k) sorted by held
    expert (experts first..first + n_held - 1), then the others, in token
    order within each: (order (T k,): the pair of each sorted position, pos
    (T, k): the buffer row of each pair, clamped to ``rows`` - 1 (a pair past
    the buffer is never held), held (T, k): whether the pair's expert is
    held, counts (n_held,): each held expert's rows, offs: their cumulative
    ends).  All on the device, with no host read."""
    s, k = idx.shape
    local = idx.reshape(-1) - first
    held = (local >= 0) & (local < n_held)
    key = torch.where(held, local, n_held)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(n_held + 1, dtype=torch.int64, device=idx.device).index_add_(
        0, key, torch.ones((), dtype=torch.int64, device=idx.device).expand(s * k))[:n_held]
    offs = counts.cumsum(0)
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(s * k, device=idx.device))
    pos = pos.clamp(max=rows - 1).reshape(s, k)
    return order, pos, held.reshape(s, k), counts, offs


class HeldExperts(nn.Module):
    """The SwiGLU experts held here, stacked: ``gate_up`` (count, 2 * inner,
    d) (the gate's rows, then the up projection's), ``down`` (count, d,
    inner)."""

    def __init__(self, count: int, dim: int, inner: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.zeros(count, 2 * inner, dim))
        self.down = nn.Parameter(torch.zeros(count, dim, inner))

    def forward(self, xp: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        h = grouped_mm(xp, self.gate_up.to(xp.dtype), offs)
        return grouped_mm(moe_glue.swiglu(h, offs), self.down.to(xp.dtype), offs)


class Router(nn.Module):
    """The f32 router (``weight`` (E, d)) and its correction bias (a buffer)."""

    def __init__(self, experts: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(experts, dim))
        self.register_buffer('e_score_correction_bias', torch.zeros(experts))


class DeepseekMoe(nn.Module):
    """DeepSeek-V3's MoE layer on the held experts (module docstring);
    ``forward`` returns (output (B, T, d), the sequence balance loss)."""

    def __init__(self, cfg: VitConfig, dtype: torch.dtype):
        super().__init__()
        from .mla import SwiGLU
        e, d = cfg.moe_num_experts, cfg.hidden_size
        self.first, self.count = cfg.moe_held or (0, e)
        if not (0 <= self.first and self.count >= 1 and self.first + self.count <= e):
            raise ValueError(f'moe_held {cfg.moe_held} must name experts of 0..{e - 1}')
        self.cfg, self.compute_dtype = cfg, dtype
        self.gate = Router(e, d)
        self.experts = HeldExperts(self.count, d, cfg.moe_intermediate_size)
        self.shared_experts = SwiGLU(d, cfg.moe_intermediate_size * cfg.moe_shared_experts,
                                     dtype)
        # this step's choices of every expert (the bias update reads and zeroes it)
        self.register_buffer('load', torch.zeros(e), persistent=False)
        # running totals: held rows, and the busiest held expert's rows, per forward
        self.register_buffer('held_rows', torch.zeros((), dtype=torch.int64), persistent=False)
        self.register_buffer('busiest_rows', torch.zeros((), dtype=torch.int64),
                             persistent=False)

    def route(self, xs: torch.Tensor):
        """(scores s (S, E) f32, chosen experts (S, k), gates (S, k) f32) of the
        tokens ``xs`` (S, d)."""
        cfg = self.cfg
        scores = torch.sigmoid(F.linear(xs.float(), self.gate.weight))
        choice = scores.detach() + self.gate.e_score_correction_bias
        idx = torch.topk(choice, cfg.moe_top_k, dim=-1, sorted=False).indices
        w = scores.gather(1, idx)
        return scores, idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.moe_routed_scale

    def forward(self, x: torch.Tensor):
        from ..utils import tracing
        cfg, dt = self.cfg, self.compute_dtype
        e, k, n_held = cfg.moe_num_experts, cfg.moe_top_k, self.count
        b, t, d = x.shape
        s = b * t
        xs = x.reshape(s, d)
        tracing.region(None)
        scores, idx, gates = self.route(xs)
        with torch.no_grad():
            ones = torch.ones((), device=x.device).expand(s * k)
            if self.training:
                self.load.index_add_(0, idx.reshape(-1), ones)
            per_seq = torch.zeros((b, e), device=x.device).scatter_add_(
                1, idx.reshape(b, t * k), ones.reshape(b, t * k)) * (e / (k * t))
        share = (scores / scores.sum(dim=-1, keepdim=True)).reshape(b, t, e).mean(dim=1)
        aux = (per_seq * share).sum(dim=1).mean()
        tracing.region('moe.route')

        # the held pairs sorted by expert, then the others; buffer rows = the first r
        r = s * min(k, n_held)
        order, pos, held, counts, offs = sort_pairs(idx, self.first, n_held, r)
        xp = moe_glue.permute(xs, order, pos, held, offs, r, dt)
        if self.training:
            with torch.no_grad():
                self.held_rows.add_(offs[-1])
                self.busiest_rows.add_(counts.max())
        tracing.region('moe.permute')

        y = self.experts(xp, offs.to(torch.int32))
        tracing.region('moe.experts')

        out = moe_glue.combine(y, gates, pos, held, order, offs).reshape(b, t, d)
        tracing.region('moe.combine')
        out = out + self.shared_experts(xs).reshape(b, t, d)
        tracing.region('moe.shared')
        return out, aux

    @torch.no_grad()
    def update_bias(self, rate: float) -> None:
        """The aux-loss-free step: b_i += rate * sign(mean load - load_i) over
        this step's counts, which are then zeroed (on the device)."""
        self.gate.e_score_correction_bias.add_(
            torch.sign(self.load.mean() - self.load), alpha=rate)
        self.load.zero_()


def deepseek_layers(model: nn.Module):
    """The ``DeepseekMoe`` layers of ``model``, in order."""
    return [m for m in model.modules() if isinstance(m, DeepseekMoe)]


def routed_counters(model: nn.Module) -> Dict[str, int]:
    """The running totals of ``model``'s MoE layers (a host read): held rows
    and the busiest held expert's rows summed over every forward of every
    layer, and the experts held a layer."""
    layers = deepseek_layers(model)
    if not layers:
        return {}
    tot = torch.stack([torch.stack([m.held_rows, m.busiest_rows]) for m in layers]).sum(0)
    return {'held_rows': int(tot[0]), 'busiest_rows': int(tot[1]),
            'held_experts': layers[0].count}
