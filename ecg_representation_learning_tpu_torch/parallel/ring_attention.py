"""Ring attention: context parallelism over a sequence axis, forward and
backward (the JAX package's ``parallel/ring_attention.py``).

  * each rank holds one sequence shard of Q, K and V;
  * forward: the K/V blocks go once around the ring (``spmd.ppermute_many``,
    one hop per block) while the local Q keeps the online-softmax statistics
    ``m``, ``l`` and ``acc`` -- the flash recursion, distributed;
  * backward (``_RingLocal``, the JAX ``custom_vjp``): dQ accumulates
    locally from the saved (q, out, lse), while each K/V block travels the
    ring once more with its dK/dV accumulators, which come home after n hops
    holding every query shard's contribution.

As in JAX the block products are plain matmuls with f32 results (JAX's
``preferred_element_type``: bf16 inputs keep f32 statistics), not a flash
kernel.  The hops of the last step's K/V are left out (JAX sends them and
drops them).  ``ring_attention_local`` runs inside a step on a mesh (the
axis resolves against ``spmd.current()``); ``ring_attention`` takes global
tensors and returns this rank's sequence shard.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import spmd

NEG_INF = -1e30


def _products(q, k):
    """q k^T with an f32 result (bf16 products are exact in f32)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def _ring_forward_pass(q, k, v, axis: str, scale: float, mesh):
    """This shard's (out, lse) with lse = m + log(max(l, 1e-30)), (B, H, T, 1)."""
    n = spmd.axis_index(axis, mesh)[1]
    b, h, t, d = q.shape
    m = torch.full((b, h, t, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        s = _products(q, k_cur) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v_cur.dtype), v_cur).float()
        m = m_new
        if step < n - 1:
            k_cur, v_cur = spmd.ppermute_many([k_cur, v_cur], axis, mesh=mesh)
    out = (acc / l).to(q.dtype)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


class _RingLocal(torch.autograd.Function):
    """Ring attention of one shard; the backward is the gradient ring."""

    @staticmethod
    def forward(ctx, q, k, v, axis, scale):
        ctx.mesh = spmd.current()    # the backward may run after the step's context
        out, lse = _ring_forward_pass(q, k, v, axis, scale, ctx.mesh)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.scale = axis, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        axis, scale = ctx.axis, ctx.scale
        n = spmd.axis_index(axis, ctx.mesh)[1]
        g32 = g.float()
        q32 = q.float()
        delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for step in range(n):
            p = torch.exp(_products(q, k_cur) * scale - lse)      # normalised probs
            dpv = torch.matmul(g32, v_cur.float().transpose(-1, -2))
            ds = p * (dpv - delta)
            dq = dq + torch.matmul(ds, k_cur.float()) * scale
            dk = dk + torch.matmul(ds.transpose(-1, -2), q32) * scale
            dv = dv + torch.matmul(p.transpose(-1, -2), g32)
            # the accumulators ride with their block; after n hops they are home
            if step < n - 1:
                k_cur, v_cur, dk, dv = spmd.ppermute_many([k_cur, v_cur, dk, dv], axis,
                                                          mesh=ctx.mesh)
            else:
                dk, dv = spmd.ppermute_many([dk, dv], axis, mesh=ctx.mesh)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: str,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention of this rank's sequence shard (B, H, T/n, D) over axis
    ``axis`` of the current mesh (``spmd.mesh_context``); on no mesh, or an
    axis of one rank, plain attention computed the same way.
    Differentiable.  Every rank of the axis must call it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingLocal.apply(q, k, v, axis, scale)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_axis: str = 'data', scale: Optional[float] = None) -> torch.Tensor:
    """Full (non-causal) attention of global (B, H, T, D) tensors with the
    sequence split over ``seq_axis`` of ``mesh``: returns this rank's shard
    (B, H, T / n, D), rank i holding positions [i T/n, (i + 1) T/n).
    Differentiable with respect to the global inputs (a rank's gradient is
    its slice's)."""
    index, n = spmd.axis_index(seq_axis, mesh)
    t = q.shape[2]
    if t % n:
        raise ValueError(f'sequence {t} does not split over {n} ranks of {seq_axis!r}')
    part = slice(index * (t // n), (index + 1) * (t // n))
    with spmd.mesh_context(mesh):
        return ring_attention_local(q[:, :, part], k[:, :, part], v[:, :, part], seq_axis,
                                    scale)
