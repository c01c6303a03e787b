"""The FusedAdamW tail -- global norm, clip and non-finite scalars, AdamW
update of every parameter leaf -- with a hand-written Hopper kernel family.

Counterpart of the JAX package's ``ops/adamw_pallas.py`` (the Pallas
``_kernel``) and of the XLA program around it in ``FusedAdamW.apply``; here
both are ``csrc/adamw.cu``.  ``adamw_update`` updates each leaf's parameter,
first moment and second moment in place:

    g'  = finite ? g * scale : 0
    mu' = b1 * mu + (1 - b1) * g'
    nu' = b2 * nu + (1 - b2) * g'^2
    p'  = p - lr * ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd * p)

``scalars`` is a 5-element f32 tensor on the leaves' device,
[scale, lr, bc1, bc2, finite], so a step reads them without a host sync.
``adamw_tail`` is the whole step: the global gradient norm, the scalars
from it (scale = min(1, clip / max(||g||, 1e-16)), or 1 without a clip;
under ``zero_nonfinite`` a non-finite norm gives scale 1 and finite 0), the
non-finite counter, then the update.  For CUDA tensors that is two kernel
launches and one pinned H2D copy of [lr, bc1, bc2] and the gradients'
addresses; for CPU tensors the plain version (``global_norm`` +
``tail_scalars_reference`` + ``adamw_update_reference``) runs the same math
leaf by leaf.

``lr_bc`` may instead be 3 f32 on the device (a row of a training step's
tape, ``train/dispatch.py``): launch 1 copies them into the scalars, and the
pinned copy carries the gradients' addresses alone.  Inside a CUDA graph
capture there is no pinned copy at all: a launch takes a device buffer
reserved before the capture (``_AdamWKernel.reserve``; one allocated inside
it could share memory with tensors that earlier nodes of the graph write),
and the addresses of the gradients the capture allocated are written into
it once, after the capture (``take_captured``), and stay valid for every
replay.  The port
updates in place where JAX returns new arrays (JAX aliases them with
``input_output_aliases``, to the same effect).

On a mesh each rank holds its shards of the leaves; ``reduce``
(:class:`NormReduce`) makes the norm the mesh-wide one: each leaf's sum of
squares times 1 / its number of copies on the mesh, summed in f64 and
all-reduced, so a sharded leaf counts its shards once each and a replicated
one once in all -- every rank then takes the same scale, the same
non-finite decision and the same counter.  On CUDA that is launch 1 with
the leaf weights, one all-reduce of its f64 sum, and launch 2 taking the
scalars from the sum (``_AdamWKernel.tail``); on the CPU the plain version
(``mesh_norm_reference``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import operator
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

_BLOCK_COLS = 6   # block table row: p, mu, nu addresses, start, leaf | count << 32, vector flag


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every element of every tensor), f32, on the
    tensors' device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class NormReduce:
    """The mesh-wide gradient norm: ``weights`` (one per leaf, 1 / the
    leaf's number of identical copies on the mesh) and the process ``group``
    whose ranks hold all of them (None: the default group)."""
    weights: Sequence[float]
    group: Any = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        dist.all_reduce(t, group=self.group)
        return t


def mesh_norm_reference(grads: Sequence[torch.Tensor], reduce: NormReduce) -> torch.Tensor:
    """Plain version of the mesh-wide norm: sqrt of the all-reduced f64
    sum of each leaf's squares times its weight, as an f32."""
    total = torch.zeros((), dtype=torch.float64, device=grads[0].device)
    for g, w in zip(grads, reduce.weights):
        total = total + w * g.double().square().sum()
    return torch.sqrt(reduce.all_reduce(total)).float()


def tail_scalars_reference(g_norm: torch.Tensor, lr_bc, *,
                           clip_norm: Optional[float], zero_nonfinite: bool) -> torch.Tensor:
    """Plain version of the scalars: [scale, lr, bc1, bc2, finite] as 5 f32
    on g_norm's device, with JAX's operations (a true f32 division);
    ``lr_bc`` is 3 floats or a tensor of 3 f32."""
    scale = torch.ones_like(g_norm)
    finite = torch.ones_like(g_norm)
    if clip_norm is not None:
        scale = torch.clamp(torch.full_like(g_norm, clip_norm)
                            / torch.clamp(g_norm, min=1e-16), max=1.0)
    if zero_nonfinite:
        ok = torch.isfinite(g_norm)
        scale = torch.where(ok, scale, 1.0)
        finite = ok.float()
    if isinstance(lr_bc, torch.Tensor):
        lr_bc = lr_bc.to(g_norm.device)
    else:
        lr_bc = torch.tensor(lr_bc, dtype=torch.float32).to(g_norm.device)
    return torch.cat([scale.reshape(1), lr_bc, finite.reshape(1)])


def adamw_update_reference(params, grads, mus, nus, scalars, *, b1: float,
                           b2: float, eps: float, wd: float) -> None:
    """Plain PyTorch version: the per-leaf math of the JAX ``FusedAdamW``."""
    scale, lr, bc1, bc2, finite = scalars.unbind(0)
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, mus, nus):
            g32 = torch.where(finite > 0, g.float() * scale, 0.0)
            mu2 = b1 * mu.float() + (1.0 - b1) * g32
            nu2 = b2 * nu + (1.0 - b2) * (g32 * g32)
            upd = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
            if wd:
                upd = upd + wd * p
            mu.copy_(mu2)
            nu.copy_(nu2)
            p.copy_(p - lr * upd)


def adamw_tail_reference(params, grads, mus, nus, lr_bc,
                         nonfinite_count: Optional[torch.Tensor] = None, *,
                         clip_norm: Optional[float], zero_nonfinite: bool, b1: float,
                         b2: float, eps: float, wd: float,
                         g_norm: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the whole tail; returns ``(grad_norm,
    nonfinite_count + !isfinite(grad_norm))`` (the count None when none is
    given).  ``g_norm``, when given, is used as the norm."""
    if g_norm is None:
        g_norm = global_norm(grads)
    scalars = tail_scalars_reference(g_norm, lr_bc, clip_norm=clip_norm,
                                     zero_nonfinite=zero_nonfinite)
    adamw_update_reference(params, grads, mus, nus, scalars, b1=b1, b2=b2, eps=eps, wd=wd)
    if nonfinite_count is not None:
        nonfinite_count = nonfinite_count + (~torch.isfinite(g_norm)).to(torch.int32)
    return g_norm, nonfinite_count


def block_table(ptrs: np.ndarray, sizes: Sequence[int], mu_bytes: int,
                chunk: int) -> np.ndarray:
    """The kernels' block table: one row of six int64 per block of ``chunk``
    elements of each leaf (a leaf of n elements takes max(1, ceil(n /
    chunk)) blocks, in leaf order) -- the p, mu, nu addresses of the block's
    first element, that element's index in the leaf, then the leaf index and
    the block's element count as two int32 (leaf in the low half), then 1
    when the leaf's p and nu are 16-byte aligned and its mu 4-element
    aligned (the kernels' vector path), else 0.  ``ptrs``: (leaves, 3)
    addresses of p, mu, nu.  Gradients are not in it: they move every step
    and reach the kernels as one address per leaf."""
    ptrs = np.asarray(ptrs, np.int64).reshape(-1, 3)
    sizes = np.asarray(sizes, np.int64)
    per_leaf = np.maximum(1, -(-sizes // chunk))
    leaf = np.repeat(np.arange(len(sizes)), per_leaf)
    first = np.cumsum(per_leaf) - per_leaf
    start = (np.arange(len(leaf)) - first[leaf]) * chunk
    aligned = (ptrs % np.array([16, 4 * mu_bytes, 16], np.int64) == 0).all(axis=1)
    rows = np.empty((len(leaf), _BLOCK_COLS), np.int64)
    rows[:, :3] = ptrs[leaf] + start[:, None] * np.array([4, mu_bytes, 4], np.int64)
    rows[:, 3] = start
    rows[:, 4] = leaf | (np.minimum(sizes[leaf] - start, chunk) << 32)
    rows[:, 5] = aligned[leaf]
    return rows


def _validate(params, grads, mus, nus) -> Tuple[torch.device, torch.dtype]:
    """What the kernels take: as many grads, mus and nus as params (>= 1),
    f32 (mu f32 or bf16, one dtype for all), each leaf's four tensors of one
    shape, contiguous, on one CUDA device."""
    n = len(params)
    if n == 0 or not (len(grads) == len(mus) == len(nus) == n):
        raise ValueError(f'adamw needs as many grads, mus and nus as params '
                         f'(>= 1): {n}, {len(grads)}, {len(mus)}, {len(nus)}')
    dev = params[0].device
    mu_dtype = mus[0].dtype
    if mu_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'mu must be float32 or bfloat16, got {mu_dtype}')
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
        for name, x, dtype in (('param', p, torch.float32), ('grad', g, torch.float32),
                               ('mu', mu, mu_dtype), ('nu', nu, torch.float32)):
            if x.dtype != dtype:
                raise TypeError(f'leaf {i}: {name} must be {dtype}, got {x.dtype}')
            if x.shape != p.shape or x.device != dev or not x.is_contiguous():
                raise ValueError(f'leaf {i}: {name} must be a contiguous '
                                 f'{tuple(p.shape)} tensor on {dev}, got '
                                 f'{tuple(x.shape)} on {x.device}')
    if dev.type != 'cuda':
        raise ValueError(f'adamw kernel takes CUDA tensors, got {dev}')
    return dev, mu_dtype


def _check_scalars(scalars: torch.Tensor, dev: torch.device) -> None:
    if (scalars.shape != (5,) or scalars.dtype != torch.float32
            or scalars.device != dev or not scalars.is_contiguous()):
        raise ValueError(f'scalars must be 5 contiguous float32 on {dev}, got '
                         f'{tuple(scalars.shape)} {scalars.dtype} {scalars.device}')


_ptr = torch.Tensor.data_ptr
_numel = torch.Tensor.numel
_dtype = operator.attrgetter('dtype')
_shape = operator.attrgetter('shape')


class _AdamWKernel:
    """ctypes binding of ``csrc/adamw.cu`` with its launch counts.

    Keeps the device block table of the last leaf set.  A call compares the
    parameters' and moments' addresses and sizes with that set's; only when
    one moved are the leaves checked (``_validate``) and the table rebuilt
    (one pinned copy on the stream, no sync; ``table_builds`` counts them).
    The gradients, which move every step, are checked each call in bulk
    (count, dtype, device, contiguity, shape) and their addresses go to the
    kernels with the step's scalars in one pinned copy.  A parameter or
    moment handed back at the same address with other strides is not
    re-checked.  Under a CUDA graph capture each launch pair takes a device
    buffer from ``reserve`` and records its gradients' addresses for
    ``take_captured``."""

    def __init__(self):
        self.launches = 0        # update kernel launches (CUDA tensors only)
        self.norm_launches = 0   # norm (or given-norm scalars) launches
        self.table_builds = 0
        self._lib = None
        self._chunk = None
        self._norm_rows = None
        self._key = None
        self._dev = None
        self._shapes = None      # the leaves' shapes, which each gradient must have
        self._mu_bf16 = 0
        self._blocks = None      # (n_blocks, 6) int64 on the device
        self._partials = None    # the norm's f64 partials, one per block of launch 1
        self._ticket = None      # the norm's last-block counter
        self._n_blocks = 0
        self._weights = None     # (key, f64 device tensor) of a NormReduce's leaf weights
        self._sum = None         # launch 1's f64 sum of squares under a NormReduce
        self._reserved = []      # device buffers for launches under a capture
        self._captured = []      # (device buffer, head, gradient addresses) captured

    def _library(self):
        if self._lib is None:
            lib = _build.load('adamw')
            lib.adamw_chunk_elems.restype = ctypes.c_int
            lib.adamw_norm_rows.restype = ctypes.c_int
            self._chunk = lib.adamw_chunk_elems()
            self._norm_rows = lib.adamw_norm_rows()
            lib.adamw_norm.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                                       + [ctypes.c_void_p] * 3
                                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
                                       + [ctypes.c_void_p] * 8)
            lib.adamw_norm.restype = ctypes.c_int
            lib.adamw_update.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 6
                                         + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                                            ctypes.c_int] + [ctypes.c_void_p] * 4)
            lib.adamw_update.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _prepare(self, params, grads, mus, nus, head: int
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """The block table for these leaves (kept when no parameter or moment
        moved, else checked and rebuilt), the gradients checked, and a pinned
        host buffer of ``head`` int64 then the gradients' addresses, with its
        device twin: ``(host, device)``, not yet copied.  Under a CUDA graph
        capture the host buffer is None: the device buffer and the addresses
        wait in ``_captured`` for ``take_captured``."""
        if not params:
            raise ValueError('adamw needs at least one parameter leaf')
        key = (params[0].device, mus[0].dtype if mus else None, *map(_ptr, params),
               *map(_ptr, mus), *map(_ptr, nus), *map(_numel, params))
        if key != self._key:
            dev, mu_dtype = _validate(params, grads, mus, nus)
            self._library()
            mu_bytes = 2 if mu_dtype == torch.bfloat16 else 4
            ptrs = np.array([(_ptr(p), _ptr(m), _ptr(v)) for p, m, v in zip(params, mus, nus)],
                            np.int64)
            rows = block_table(ptrs, [p.numel() for p in params], mu_bytes, self._chunk)
            self._key = None   # a failure below leaves no half-built table
            self._blocks = torch.from_numpy(rows).pin_memory().to(dev, non_blocking=True)
            self._partials = torch.empty(-(-len(rows) // self._norm_rows),
                                         dtype=torch.float64, device=dev)
            self._ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            self._n_blocks, self._dev, self._mu_bf16 = len(rows), dev, int(mu_bytes == 2)
            self._shapes = [p.shape for p in params]
            self._key = key
            self.table_builds += 1
        n = len(self._shapes)
        if not (len(grads) == n and set(map(_dtype, grads)) == {torch.float32}
                and set(map(torch.Tensor.get_device, grads)) == {self._dev.index}
                and all(map(torch.Tensor.is_contiguous, grads))
                and list(map(_shape, grads)) == self._shapes):
            _validate(params, grads, mus, nus)   # raises, saying which leaf
            raise ValueError('adamw: the gradients do not match the parameters')
        addrs = np.fromiter(map(_ptr, grads), np.int64, n)
        if torch.cuda.is_current_stream_capturing():
            if not self._reserved:
                raise RuntimeError('adamw under a CUDA graph capture needs a buffer from '
                                   'reserve() for each launch pair')
            dev = self._reserved.pop()[:head + n]
            self._captured.append((dev, head, addrs))
            return None, dev
        host = torch.empty(head + n, dtype=torch.int64, pin_memory=True)
        host.numpy()[head:] = addrs
        return host, torch.empty(head + n, dtype=torch.int64, device=self._dev)

    def reserve(self, count: int) -> None:
        """Before a CUDA graph capture of ``count`` launch pairs on the
        current leaves (after an eager call built their table): one device
        buffer each for the scalars and the gradients' addresses, allocated
        outside the capture, so that no node of the graph writes it."""
        if self._shapes is None:
            raise RuntimeError('adamw.reserve needs the leaves of an eager call first')
        self._reserved = [torch.empty(4 + len(self._shapes), dtype=torch.int64,
                                      device=self._dev) for _ in range(count)]

    def take_captured(self) -> list:
        """After a CUDA graph capture: write the gradients' addresses into
        the buffer of every launch captured since ``reserve`` (one copy each,
        outside the capture) and return those buffers with the block table
        and the norm's scratch, which the caller keeps alive with the graph:
        its kernels read them at every replay (the gradients stay at their
        addresses in its pool), also after another leaf set (another
        trainer) has made this binding build a new table."""
        out = [self._blocks, self._partials, self._ticket] if self._captured else []
        for dev, head, addrs in self._captured:
            dev[head:].copy_(torch.from_numpy(addrs))
            out.append(dev)
        self._captured, self._reserved = [], []
        return out

    def _launch_update(self, gptrs: torch.Tensor, scalars: torch.Tensor, stream: int, *,
                       b1: float, b2: float, eps: float, wd: float, mesh_tail=None) -> None:
        """Launch 2; ``mesh_tail`` = (sum, clip_norm, zero_nonfinite,
        norm_out, count_in, count_out) takes the scalars from the mesh-wide
        sum."""
        ptr = lambda t: None if t is None else t.data_ptr()
        if mesh_tail is None:
            tail = (None, 0.0, 0, 0, None, None, None)
        else:
            total, clip, zero_nonfinite, norm_out, count_in, count_out = mesh_tail
            tail = (total.data_ptr(), 0.0 if clip is None else float(clip),
                    int(clip is not None), int(zero_nonfinite), norm_out.data_ptr(),
                    ptr(count_in), ptr(count_out))
        err = self._lib.adamw_update(self._blocks.data_ptr(), gptrs.data_ptr(), self._n_blocks,
                                     scalars.data_ptr(), self._mu_bf16, b1, 1.0 - b1, b2,
                                     1.0 - b2, eps, wd, *tail, stream)
        if err != 0:
            raise RuntimeError(f'adamw_update launch failed: CUDA error {err}')
        self.launches += 1

    def __call__(self, params, grads, mus, nus, scalars, *, b1: float, b2: float,
                 eps: float, wd: float) -> None:
        """The update alone, with ``scalars`` given: one pinned copy of the
        gradients' addresses and one launch."""
        host, gptrs = self._prepare(params, grads, mus, nus, 0)
        _check_scalars(scalars, self._dev)
        with torch.cuda.device(self._dev):
            if host is not None:
                gptrs.copy_(host, non_blocking=True)
            self._launch_update(gptrs, scalars, torch.cuda.current_stream().cuda_stream,
                                b1=b1, b2=b2, eps=eps, wd=wd)

    def _norm_scalars(self, host, ws, lr_bc, nonfinite_count, clip_norm, zero_nonfinite,
                      g_norm, stream):
        """The pinned copy and launch 1 (after ``_prepare(..., 4)`` gave
        ``host`` and ``ws``): ``(scalars, grad_norm, count_out, gptrs)``.
        The device buffer is [scale, lr, bc1, bc2, finite, grad_norm, -, -]
        as f32 in its first 4 int64, then the gradients' addresses; the copy
        fills all of it (lr, bc1, bc2 from ``lr_bc`` floats), and launch 1
        then writes scale, finite and grad_norm (and lr, bc1, bc2 from an
        ``lr_bc`` tensor on the device)."""
        dev = self._dev
        for name, t, dtype in (('g_norm', g_norm, torch.float32),
                               ('nonfinite_count', nonfinite_count, torch.int32)):
            if t is not None and (t.numel() != 1 or t.dtype != dtype or t.device != dev):
                raise ValueError(f'{name} must be one {dtype} on {dev}, got '
                                 f'{tuple(t.shape)} {t.dtype} {t.device}')
        lr_dev = _lr_bc_device(lr_bc, dev)
        if host is None and lr_dev is None:
            raise RuntimeError('a captured adamw step needs lr_bc on the device')
        if host is not None:
            if lr_dev is None:
                host.numpy()[:4].view(np.float32)[1:4] = lr_bc
            ws.copy_(host, non_blocking=True)
        f32 = ws[:4].view(torch.float32)
        gptrs = ws[4:]
        grad_norm = f32[5] if g_norm is None else g_norm
        count_out = None if nonfinite_count is None else torch.empty_like(nonfinite_count)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = self._lib.adamw_norm(
            self._blocks.data_ptr(), gptrs.data_ptr(), self._n_blocks,
            self._partials.data_ptr(), self._ticket.data_ptr(), ptr(g_norm),
            0.0 if clip_norm is None else float(clip_norm), int(clip_norm is not None),
            int(zero_nonfinite), f32.data_ptr(), ptr(lr_dev),
            ptr(None if g_norm is not None else grad_norm),
            ptr(nonfinite_count), ptr(count_out), None, None, stream)
        if err != 0:
            raise RuntimeError(f'adamw_norm launch failed: CUDA error {err}')
        self.norm_launches += 1
        return f32[:5], grad_norm, count_out, gptrs

    def norm_scalars(self, params, grads, mus, nus, lr_bc: Sequence[float],
                     nonfinite_count: Optional[torch.Tensor] = None, *,
                     clip_norm: Optional[float], zero_nonfinite: bool,
                     g_norm: Optional[torch.Tensor] = None):
        """Launch 1 alone, after one pinned H2D copy of ``lr_bc`` = (lr,
        bc1, bc2) and the gradients' addresses: returns ``(scalars,
        grad_norm, nonfinite_count + !finite)``, the scalars [scale, lr,
        bc1, bc2, finite] as 5 f32 on the device (the count None when none is
        given).  ``g_norm``, when given, is used as the norm and no gradient
        is read."""
        host, ws = self._prepare(params, grads, mus, nus, 4)
        with torch.cuda.device(self._dev):
            return self._norm_scalars(host, ws, lr_bc, nonfinite_count, clip_norm,
                                      zero_nonfinite, g_norm,
                                      torch.cuda.current_stream().cuda_stream)[:3]

    def _mesh_tail(self, host, ws, lr_bc, nonfinite_count, clip_norm, zero_nonfinite,
                   reduce: NormReduce, stream, **kw):
        """Under a ``NormReduce``: launch 1 with the leaf weights (its f64
        sum of squares), the all-reduce of the sum, launch 2 from it.  With
        ``lr_bc`` on the device (a step tape) nothing reads the host, so a
        CUDA graph captures it, the all-reduce included."""
        dev = self._dev
        wkey = (self._key, tuple(reduce.weights))
        if self._weights is None or self._weights[0] != wkey:
            w = torch.tensor(list(reduce.weights), dtype=torch.float64)
            if w.numel() != len(self._shapes):
                raise ValueError(f'NormReduce has {w.numel()} weights for '
                                 f'{len(self._shapes)} leaves')
            self._weights = (wkey, w.to(dev))
            self._sum = torch.empty((), dtype=torch.float64, device=dev)
        if nonfinite_count is not None and (nonfinite_count.numel() != 1
                                            or nonfinite_count.dtype != torch.int32
                                            or nonfinite_count.device != dev):
            raise ValueError(f'nonfinite_count must be one int32 on {dev}')
        lr_dev = _lr_bc_device(lr_bc, dev)
        if host is None and lr_dev is None:
            raise RuntimeError('a captured adamw step needs lr_bc on the device')
        if host is not None:
            if lr_dev is None:
                host.numpy()[:4].view(np.float32)[1:4] = lr_bc
            ws.copy_(host, non_blocking=True)
        f32 = ws[:4].view(torch.float32)
        if lr_dev is not None:   # a step tape's row: the norm launch's mesh branch copies none
            f32[1:4].copy_(lr_dev)
        gptrs = ws[4:]
        err = self._lib.adamw_norm(
            self._blocks.data_ptr(), gptrs.data_ptr(), self._n_blocks,
            self._partials.data_ptr(), self._ticket.data_ptr(), None, 0.0, 0, 0,
            f32.data_ptr(), None, None, None, None, self._weights[1].data_ptr(),
            self._sum.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f'adamw_norm launch failed: CUDA error {err}')
        self.norm_launches += 1
        reduce.all_reduce(self._sum)
        grad_norm = f32[5]
        count_out = None if nonfinite_count is None else torch.empty_like(nonfinite_count)
        self._launch_update(gptrs, f32[:5], stream, mesh_tail=(
            self._sum, clip_norm, zero_nonfinite, grad_norm, nonfinite_count, count_out), **kw)
        return grad_norm, count_out

    def tail(self, params, grads, mus, nus, lr_bc,
             nonfinite_count: Optional[torch.Tensor] = None, *, clip_norm: Optional[float],
             zero_nonfinite: bool, b1: float, b2: float, eps: float, wd: float,
             g_norm: Optional[torch.Tensor] = None, reduce: Optional[NormReduce] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The whole tail in two launches and one pinned H2D copy; returns
        ``(grad_norm, nonfinite_count)`` as ``adamw_tail_reference``.  With
        ``reduce`` the norm is the mesh-wide one (one all-reduce between the
        launches)."""
        host, ws = self._prepare(params, grads, mus, nus, 4)
        if reduce is not None and g_norm is None:
            with torch.cuda.device(self._dev):
                return self._mesh_tail(host, ws, lr_bc, nonfinite_count, clip_norm,
                                       zero_nonfinite, reduce,
                                       torch.cuda.current_stream().cuda_stream,
                                       b1=b1, b2=b2, eps=eps, wd=wd)
        with torch.cuda.device(self._dev):
            stream = torch.cuda.current_stream().cuda_stream
            scalars, grad_norm, count, gptrs = self._norm_scalars(
                host, ws, lr_bc, nonfinite_count, clip_norm, zero_nonfinite, g_norm, stream)
            self._launch_update(gptrs, scalars, stream, b1=b1, b2=b2, eps=eps, wd=wd)
        return grad_norm, count


adamw_kernel = _AdamWKernel()


def _lr_bc_device(lr_bc, dev: torch.device) -> Optional[torch.Tensor]:
    """``lr_bc`` when it is a tensor (checked: 3 contiguous f32 on ``dev``),
    else None (floats, written into the pinned copy)."""
    if not isinstance(lr_bc, torch.Tensor):
        return None
    if (lr_bc.shape != (3,) or lr_bc.dtype != torch.float32 or lr_bc.device != dev
            or not lr_bc.is_contiguous()):
        raise ValueError(f'lr_bc must be 3 contiguous float32 on {dev}, got '
                         f'{tuple(lr_bc.shape)} {lr_bc.dtype} {lr_bc.device}')
    return lr_bc


def _device_type(params) -> str:
    if not params:
        raise ValueError('adamw needs at least one parameter leaf')
    dev = params[0].device.type
    if dev not in ('cuda', 'cpu'):
        raise RuntimeError(f'no adamw for device {params[0].device}')
    return dev


def adamw_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                 scalars: torch.Tensor, *, b1: float, b2: float, eps: float,
                 wd: float) -> None:
    """One AdamW step on every leaf with the given ``scalars``, in place.
    CUDA tensors: one kernel launch; CPU tensors: the plain version."""
    kw = dict(b1=b1, b2=b2, eps=eps, wd=wd)
    if _device_type(params) == 'cuda':
        return adamw_kernel(params, grads, mus, nus, scalars, **kw)
    return adamw_update_reference(params, grads, mus, nus, scalars, **kw)


def adamw_tail(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
               lr_bc, nonfinite_count: Optional[torch.Tensor] = None, *,
               clip_norm: Optional[float], zero_nonfinite: bool, b1: float, b2: float,
               eps: float, wd: float, g_norm: Optional[torch.Tensor] = None,
               reduce: Optional[NormReduce] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FusedAdamW step from the gradients: norm, scalars, counter and
    update, in place; returns ``(grad_norm, nonfinite_count)``.  CUDA
    tensors: two kernel launches; CPU tensors: the plain version.  ``reduce``
    makes the norm the mesh-wide one (:class:`NormReduce`)."""
    kw = dict(clip_norm=clip_norm, zero_nonfinite=zero_nonfinite, b1=b1, b2=b2, eps=eps,
              wd=wd, g_norm=g_norm)
    if _device_type(params) == 'cuda':
        return adamw_kernel.tail(params, grads, mus, nus, lr_bc, nonfinite_count, **kw,
                                 reduce=reduce)
    if reduce is not None and g_norm is None:
        kw['g_norm'] = mesh_norm_reference(grads, reduce)
    return adamw_tail_reference(params, grads, mus, nus, lr_bc, nonfinite_count, **kw)
