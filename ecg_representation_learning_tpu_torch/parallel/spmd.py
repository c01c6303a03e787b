"""A rank's view of the mesh while a step runs.

JAX writes one program for the whole mesh and GSPMD inserts the collectives;
the port runs one process per rank, so each rank runs its part and the
collectives are written out here:

  * the Megatron pair over 'model' (Shoeybi et al. 2019): ``copy_to_model``
    (identity forward, all-reduce of the gradient) in front of a
    column-parallel layer and ``reduce_from_model`` (``sum_over`` the model
    axis: all-reduce forward, identity backward) behind a row-parallel one;
    ``gather_from_model`` (all-gather forward, the rank's slice of the
    gradient backward) behind a column-parallel layer whose output goes on
    replicated;
  * over 'data': ``all_reduce_data`` / ``all_gather_data`` with their
    gradients (global MoE statistics, NT-Xent negatives; written out here,
    as ``torch.distributed.nn``'s all-gather backward does not run on a
    subgroup over gloo) and the
    gradient-free ``gather_rows`` / ``mean_over_data`` (metrics);
  * the indices a rank's slice has in the global arrays, so that randomness
    keyed by an index -- the hashed dropout masks, the kernels' ``bh`` --
    and draws made for the global batch give a rank what one device would
    give those rows (``batch_frame``, ``global_draw``);
  * over any axis of a mesh, for ring context parallelism and the GPipe
    pipeline: ``ppermute`` (JAX's ``lax.ppermute`` by a shift around the
    ring; its gradient is the inverse permutation) and ``sum_over`` (JAX's
    ``psum`` into a replicated output: the sum forward, the identity
    backward).  Each hop is one ``batch_isend_irecv`` that sends to the
    next rank and receives from the previous one, so a ring cannot
    deadlock; on a gloo group CUDA tensors go through pinned host buffers
    (gloo's point-to-point ops take CPU tensors), on NCCL they stay on the
    device.

``mesh_context(mesh)`` makes ``mesh`` the current one (``current()``) for the
forwards inside it, and routes attention through the sharded flash wrap
(``ops.attention.flash_tp_context``) when the model axis is > 1.  Outside a
context, or on a mesh of one rank per axis, every helper is the identity.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
        with (flash_tp_context(mesh) if mesh.shape.get('model', 1) > 1
              else contextlib.nullcontext()):
            yield
    finally:
        _MESH = old


def _axis(name: str, mesh=None):
    """(size, index, group) of axis ``name`` of ``mesh`` (default: the
    current one); (1, 0, None) without one, or when the mesh has no such
    axis or it has one rank."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None or mesh.shape.get(name, 1) == 1:
        return 1, 0, None
    return mesh.shape[name], mesh.index(name), mesh.group(name)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over axis ``axis`` of ``mesh`` (default: the current
    one) with the identity as its gradient: JAX's ``psum`` inside a
    ``shard_map`` whose output is replicated, where each rank's cotangent
    is the replicated one."""
    n, _, group = _axis(axis, mesh)
    return x if n == 1 else _SumOver.apply(x, group)


def axis_index(axis: str, mesh=None) -> Tuple[int, int]:
    """(index, size) of this rank on axis ``axis`` of ``mesh`` (default: the
    current one); (0, 1) without one."""
    n, index, _ = _axis(axis, mesh)
    return index, n


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
    return sum_over(x, 'model')


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model axis' slices of the last dim, concatenated in rank order;
    the gradient of the rank's slice is its part of the incoming one."""
    n, index, group = _axis('model')
    return x if n == 1 else _GatherFromModel.apply(x, group, n, index)


def model_index() -> Tuple[int, int]:
    """(index, size) of this rank on the model axis."""
    return axis_index('model')


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
    return axis_index('data')


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


# ------------------------------------------------------- any axis: rings
def _hop(tensors: Sequence[torch.Tensor], group, shift: int) -> List[torch.Tensor]:
    """One ring hop of every tensor of ``tensors`` over ``group``: each
    rank sends to (index + shift) mod n and receives from (index - shift)
    mod n, in one ``batch_isend_irecv``."""
    n, index = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (index + shift) % n)
    src = dist.get_global_rank(group, (index - shift) % n)
    staged = dist.get_backend(group) == 'gloo' and tensors[0].is_cuda
    if staged:   # gloo moves host memory only
        send = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t.detach())
                for t in tensors]
        recv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    else:
        send = [t.detach().contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
    ops = [op for s, r in zip(send, recv)
           for op in (dist.P2POp(dist.isend, s, dst, group),
                      dist.P2POp(dist.irecv, r, src, group))]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        return [r.to(t.device, non_blocking=True) for r, t in zip(recv, tensors)]
    return recv


def ppermute_many(tensors: Sequence[torch.Tensor], axis: str, shift: int = 1,
                  mesh=None) -> List[torch.Tensor]:
    """``tensors`` moved ``shift`` places around axis ``axis`` of ``mesh``
    (default: the current one) in one hop, without gradient; the identity
    on an axis of one rank."""
    n, _, group = _axis(axis, mesh)
    if n == 1:
        return list(tensors)
    return _hop(tensors, group, shift)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _hop([x], group, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return _hop([g], ctx.group, -ctx.shift)[0], None, None


def ppermute(x: torch.Tensor, axis: str, shift: int = 1, mesh=None) -> torch.Tensor:
    """JAX's ``lax.ppermute`` with the ring permutation i -> i + ``shift``
    over axis ``axis`` of ``mesh`` (default: the current one); the gradient
    goes back by the inverse permutation.  Every rank of the axis must call
    it, forward and backward, in the same order."""
    n, _, group = _axis(axis, mesh)
    return x if n == 1 else _Ppermute.apply(x, group, shift)


def sum_grads(grads: Sequence[torch.Tensor], axis: str, mesh=None, divide: int = 1) -> None:
    """Sum ``grads`` over axis ``axis`` of ``mesh`` (default: the current
    one) in place -- what JAX's ``shard_map`` transpose gives a parameter
    replicated over that axis -- then divide by ``divide``: one all-reduce
    of the tensors flattened into one buffer."""
    n, _, group = _axis(axis, mesh)
    if n == 1 and divide == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    if n > 1:
        dist.all_reduce(flat, group=group)
    if divide != 1:
        flat.div_(divide)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
