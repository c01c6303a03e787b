"""A rank's view of the ('data', 'model') mesh while a step runs.

JAX writes one program for the whole mesh and GSPMD inserts the collectives;
the port runs one process per rank, so each rank runs its part and the
collectives are written out here:

  * the Megatron pair over 'model' (Shoeybi et al. 2019): ``copy_to_model``
    (identity forward, all-reduce of the gradient) in front of a
    column-parallel layer and ``reduce_from_model`` (all-reduce forward,
    identity backward) behind a row-parallel one; ``gather_from_model``
    (all-gather forward, the rank's slice of the gradient backward) behind a
    column-parallel layer whose output goes on replicated;
  * over 'data': ``all_reduce_data`` / ``all_gather_data`` with their
    gradients (global MoE statistics, NT-Xent negatives; written out here,
    as ``torch.distributed.nn``'s all-gather backward does not run on a
    subgroup over gloo) and the
    gradient-free ``gather_rows`` / ``mean_over_data`` (metrics);
  * the indices a rank's slice has in the global arrays, so that randomness
    keyed by an index -- the hashed dropout masks, the kernels' ``bh`` --
    and draws made for the global batch give a rank what one device would
    give those rows (``batch_frame``, ``global_draw``).

``mesh_context(mesh)`` makes ``mesh`` the current one (``current()``) for the
forwards inside it, and routes attention through the sharded flash wrap
(``ops.attention.flash_tp_context``) when the model axis is > 1.  Outside a
context, or on a mesh of one rank per axis, every helper is the identity.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_MESH = None


def current():
    """The mesh of the step running now, or None."""
    return _MESH


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` current (None: leave things as they are) and, when its
    model axis is > 1, route attention through the sharded flash wrap."""
    global _MESH
    if mesh is None:
        yield
        return
    from ..ops.attention import flash_tp_context
    old, _MESH = _MESH, mesh
    try:
        with (flash_tp_context(mesh) if mesh.shape['model'] > 1 else contextlib.nullcontext()):
            yield
    finally:
        _MESH = old


def _axis(name: str):
    """(size, index, group) of axis ``name`` of the current mesh; (1, 0,
    None) without one."""
    if _MESH is None or _MESH.shape[name] == 1:
        return 1, 0, None
    return _MESH.shape[name], _MESH.index(name), _MESH.group(name)


# --------------------------------------------------------------- model axis
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.n, ctx.index = n, index
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.index].contiguous(), None, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; the gradient is summed over the model axis."""
    n, _, group = _axis('model')
    return x if n == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model axis; the gradient passes unchanged."""
    n, _, group = _axis('model')
    return x if n == 1 else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model axis' slices of the last dim, concatenated in rank order;
    the gradient of the rank's slice is its part of the incoming one."""
    n, index, group = _axis('model')
    return x if n == 1 else _GatherFromModel.apply(x, group, n, index)


def model_index() -> Tuple[int, int]:
    """(index, size) of this rank on the model axis."""
    n, index, _ = _axis('model')
    return index, n


def model_slice(size: int) -> Tuple[int, int]:
    """(offset, count) of the rank's part of ``size`` items split evenly
    over the model axis."""
    n, index, _ = _axis('model')
    return index * (size // n), size // n


# ---------------------------------------------------------------- data axis
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.index = group, index
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()   # every rank's use of every part, summed
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index], None, None, None


def all_reduce_data(x: torch.Tensor) -> torch.Tensor:
    """The sum over the data axis, with its gradient (an all-reduce)."""
    n, _, group = _axis('data')
    return x if n == 1 else _AllReduce.apply(x, group)


def all_gather_data(x: torch.Tensor) -> Sequence[torch.Tensor]:
    """Every data rank's ``x`` in rank order, with the gradient (each rank's
    part gets the sum over the ranks of what they did with it)."""
    n, index, group = _axis('data')
    return [x] if n == 1 else list(_AllGather.apply(x, group, n, index).unbind(0))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data ranks' rows of ``x`` concatenated in rank order (no
    gradient): the global batch of a per-rank result."""
    n, _, group = _axis('data')
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (no gradient)."""
    n, _, group = _axis('data')
    if n == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x / n


def data_counts(x: torch.Tensor) -> torch.Tensor:
    """(n_data, *x.shape): every data rank's ``x`` stacked (no gradient)."""
    n, _, group = _axis('data')
    if n == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def data_index() -> Tuple[int, int]:
    """(index, size) of this rank on the data axis."""
    n, index, _ = _axis('data')
    return index, n


# ---------------------------------------------------- global indices, draws
def batch_frame(b_local: int) -> Optional[Tuple[int, int]]:
    """(offset, global size) of the rank's ``b_local`` rows in the global
    batch, or None on one data rank."""
    n, index, _ = _axis('data')
    return None if n == 1 else (index * b_local, n * b_local)


def frame(shape: Sequence[int], batch_dim: Optional[int] = 0,
          model_dim: Optional[int] = None) -> Optional[Dict[int, Tuple[int, int]]]:
    """Where a rank's tensor of ``shape`` sits in the global one: {dim:
    (offset, global size)} for the dim split over 'data' (``batch_dim``) and
    the one split over 'model' (``model_dim``); None when neither is split
    (the tensor is the global one)."""
    out = {}
    nd, idx_d, _ = _axis('data')
    nm, idx_m, _ = _axis('model')
    if batch_dim is not None and nd > 1:
        out[batch_dim % len(shape)] = (idx_d * shape[batch_dim], nd * shape[batch_dim])
    if model_dim is not None and nm > 1:
        out[model_dim % len(shape)] = (idx_m * shape[model_dim], nm * shape[model_dim])
    return out or None


def global_draw(b_local: int, draw: Callable[[int], object]):
    """``draw(n)`` made for the global batch and cut to the rank's rows:
    ``draw`` returns a tensor or a tuple/dict of tensors with n rows, drawn
    from a generator that is in the same state on every rank; on one data
    rank it is just ``draw(b_local)``."""
    fr = batch_frame(b_local)
    if fr is None:
        return draw(b_local)
    off, total = fr
    out = draw(total)
    if isinstance(out, dict):
        return {k: v[off:off + b_local] for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(v[off:off + b_local] for v in out)
    return out[off:off + b_local]
