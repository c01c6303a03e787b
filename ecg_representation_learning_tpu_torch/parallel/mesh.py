"""Device mesh and sharding rules (the JAX package's ``parallel/mesh.py``).

A 2-D mesh over ('data', 'model') (``make_mesh``), or over ('data',
'stage') for the GPipe pipeline (``make_pp_mesh``: rank = d * S + s, as
JAX's lays devices out; ``stage_norm_weights`` gives each
leaf's copies on it), one rank per device.  On the ('data', 'model') mesh:

  * data parallelism: each data rank takes its rows of the global batch;
    gradients are averaged over 'data' by DDP, or reduce-scattered by FSDP2
    (``fsdp``);
  * Megatron tensor parallelism over 'model': the qkv and fc1 kernels
    column-sharded, the attention-out and fc2 kernels row-sharded, the patch
    projection column-sharded and gathered, the MoE expert stacks sharded on
    their expert axis (expert parallelism), by the JAX partition rules
    (``param_spec``), matched on each parameter's flax path
    (``models.port.flax_path``); everything else replicated;
  * ``fsdp``: ZeRO-style storage sharding over 'data' on top: each leaf's
    largest free dim that 'data' divides (the JAX ``_fsdp_spec``), as FSDP2
    ``fully_shard`` placements; a leaf the JAX rule leaves replicated is an
    ``ignored_params`` leaf of FSDP2, its gradient all-reduced over 'data'.

Specs are written in the flax layout, as in JAX (a Dense ``kernel`` is
(in, out), the port's Linear ``weight`` (out, in)); ``ShardedModel`` maps
them onto the port's tensors.  One difference of layout, none of values:
the qkv columns a rank holds are its heads' q, k and v columns (the
Megatron layout), where JAX's contiguous column block is resharded by
GSPMD before the attention.  Checkpoints gather the full tensors
(``full_state``), so they are the same files whatever the mesh.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
STAGE_AXIS = 'stage'


class P(tuple):
    """A partition spec: one mesh axis name (or None) per dim, as JAX's
    ``PartitionSpec``; trailing dims left out are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f'P{tuple(self)!r}'


class Mesh:
    """This rank's place on a 2-D ``DeviceMesh``: ``shape`` {axis: size}
    as JAX's ``mesh.shape`` ({'data': n_data, 'model': n_model} or {'data':
    n_data, 'stage': n_stage}), ``index(axis)``, ``group(axis)``, and the
    rank's ``device``.  ``tensor_parallel``: apply the Megatron plan
    (default: when the model axis is > 1; True on a model axis of 1 runs its
    code path, with no collective)."""

    def __init__(self, device_mesh, device: torch.device,
                 tensor_parallel: Optional[bool] = None):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.shape = {name: device_mesh.size(i)
                      for i, name in enumerate(device_mesh.mesh_dim_names)}
        self.tensor_parallel = (self.shape.get(MODEL_AXIS, 1) > 1 if tensor_parallel is None
                                else bool(tensor_parallel))

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f'Mesh({self.shape}, device={self.device})'


def _device_mesh(n_outer: int, n_inner: int, names: Tuple[str, str], devices, device):
    """(DeviceMesh over ``devices`` -- default every rank -- reshaped
    row-major to (n_outer, n_inner) with ``names``, this rank's device)."""
    from torch.distributed.device_mesh import DeviceMesh

    from .distributed import local_device
    if not dist.is_initialized():
        raise RuntimeError('a mesh needs a torch.distributed process group: run under '
                           'torchrun (initialize_distributed) or the local launcher')
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    n = len(ranks)
    if n_outer * n_inner != n or n != dist.get_world_size():
        raise ValueError(f'a {n_outer} x {n_inner} mesh needs {n_outer * n_inner} ranks, '
                         f'the group has {dist.get_world_size()} ({n} given)')
    device = torch.device(device) if device is not None else local_device()
    return DeviceMesh(device.type, torch.tensor(ranks).reshape(n_outer, n_inner),
                      mesh_dim_names=names), device


def make_pp_mesh(n_stage: int, n_data: int = 1, devices=None, *, device=None) -> Mesh:
    """A ('data', 'stage') mesh for the GPipe pipeline (JAX's
    ``train/pipeline_vit.make_pp_mesh``): microbatch rows over 'data',
    layers over 'stage'; rank d * n_stage + s is stage s of data rank d
    (JAX's ``np.asarray(devices).reshape(n_data, n_stage)``).  ``device`` as
    ``make_mesh``."""
    dm, device = _device_mesh(n_data, n_stage, (DATA_AXIS, STAGE_AXIS), devices, device)
    return Mesh(dm, device)


def stage_norm_weights(names, stage_names, mesh: Mesh) -> List[float]:
    """Per leaf of ``names``, 1 / its identical copies on a ('data',
    'stage') mesh, for the mesh-wide norm: a stage leaf (in
    ``stage_names``) has one copy per data rank, every other (boundary)
    leaf one per rank."""
    n_data, n_stage = mesh.shape[DATA_AXIS], mesh.shape[STAGE_AXIS]
    stage_names = set(stage_names)
    return [1.0 / (n_data if name in stage_names else n_data * n_stage) for name in names]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None, *,
              device=None, tensor_parallel: Optional[bool] = None) -> Mesh:
    """A ('data', 'model') mesh over the ranks ``devices`` (default: every
    rank of the default process group), laid out row-major as JAX's
    ``np.asarray(devices).reshape(n_data, n_model)``.  Defaults to every rank
    on 'data'.  ``device``: this rank's device (default: ``cuda:LOCAL_RANK``
    under NCCL, else the CPU).  Needs the process group
    (``initialize_distributed`` or the launcher), one of one rank too."""
    devices = None if devices is None else list(devices)
    if n_data is None:
        if not dist.is_initialized():
            raise RuntimeError('make_mesh needs a torch.distributed process group: run '
                               'under torchrun (initialize_distributed) or the local launcher')
        n = dist.get_world_size() if devices is None else len(devices)
        if n % n_model:
            raise ValueError(f'{n} ranks do not split into model groups of {n_model}')
        n_data = n // n_model
    dm, device = _device_mesh(n_data, n_model, (DATA_AXIS, MODEL_AXIS), devices, device)
    return Mesh(dm, device, tensor_parallel)


# --- parameter partition rules -------------------------------------------------
# matched against the '/'-joined flax param path; first hit wins
_PARAM_RULES: Tuple[Tuple[str, P], ...] = (
    # column-parallel: shard output features over 'model'
    (r'attn/qkv/kernel$',        P(None, MODEL_AXIS)),
    (r'mlp/fc1/kernel$',         P(None, MODEL_AXIS)),
    (r'mlp/fc1/bias$',           P(MODEL_AXIS)),
    # row-parallel: shard input features over 'model'
    (r'attn/out/kernel$',        P(MODEL_AXIS, None)),
    (r'mlp/fc2/kernel$',         P(MODEL_AXIS, None)),
    # patch embedding: shard the hidden dim
    (r'patch_embed/proj/kernel$', P(None, MODEL_AXIS)),
    # expert parallelism: MoE expert FFN stacks (E, d, f) shard the leading
    # expert axis over 'model' (models/moe.py); the router stays replicated
    (r'moe/w[12]$',              P(MODEL_AXIS, None, None)),
    (r'moe/b[12]$',              P(MODEL_AXIS, None)),
    # everything else replicated (norms, biases, pos/cls embeddings, head)
)


def param_spec(path: str, ndim: int) -> P:
    """The spec of the flax leaf ``path`` with ``ndim`` dims (the JAX rule)."""
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            if ndim == len(spec) + 1:
                # scan-over-layers stacking (VitConfig.scan_blocks): kernels
                # carry a leading (L,) axis -- keep it replicated, shift the
                # rule onto the original dims
                return P(None, *spec)
            if len([a for a in spec if a is not None]) <= ndim:
                return spec
    return P()  # replicated


def _fsdp_spec(spec: P, shape: Tuple[int, ...], n_data: int) -> P:
    """Additionally shard the largest free dim over 'data' (ZeRO-style fully
    sharded storage).  Dims already on 'model' stay; indivisible or tiny
    params stay replicated over 'data' (the JAX rule)."""
    if n_data <= 1 or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for d, size in enumerate(shape):
        if entries[d] is None and size % n_data == 0 and size > best_size:
            best, best_size = d, size
    if best is None or best_size < 2 * n_data:  # not worth slicing tiny params
        return spec
    entries[best] = DATA_AXIS
    return P(*entries)


def _flax_leaf(name: str, shape: Tuple[int, ...]) -> Tuple[str, Tuple[int, ...], bool]:
    """(flax path, flax shape, is a Dense kernel) of the port's parameter."""
    from ..models.port import flax_path
    path = flax_path(name)
    kernel = path[-1] == 'kernel'
    if kernel:
        shape = shape[:-2] + (shape[-1], shape[-2])
    return '/'.join(path), tuple(shape), kernel


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(v if isinstance(v, tuple) else v.shape) for k, v in params.items()}


def param_shardings(params, mesh, fsdp: bool = False) -> Dict[str, P]:
    """The spec of each parameter (by the port's name; in the flax layout) of
    a model, a state_dict or a {name: shape} map: the Megatron rules, and
    with ``fsdp`` the 'data' dim of ZeRO storage sharding."""
    n_data = mesh.shape[DATA_AXIS]
    out = {}
    for name, shape in _shapes(params).items():
        path, fshape, _ = _flax_leaf(name, shape)
        spec = param_spec(path, len(fshape))
        out[name] = _fsdp_spec(spec, fshape, n_data) if fsdp else spec
    return out


def opt_state_shardings(opt_state, params_shardings: Mapping[str, P], mesh) -> Dict:
    """Specs of a ``FusedAdamWState``: Adam's moments are laid out like the
    params (under FSDP most of the memory saving lives there), the count is
    replicated."""
    return {'count': replicated(mesh), 'mu': dict(params_shardings),
            'nu': dict(params_shardings)}


def batch_sharding(mesh) -> P:
    """Batch arrays: sharded over 'data' on the leading axis."""
    return P(DATA_AXIS)


def replicated(mesh) -> P:
    return P()


def _torch_dim(flax_dim: int, ndim: int, kernel: bool) -> int:
    if kernel and flax_dim >= ndim - 2:
        return 2 * ndim - 3 - flax_dim     # the last two dims are swapped
    return flax_dim


def _dims(spec: P, ndim: int, kernel: bool) -> Dict[str, int]:
    """{axis: torch dim} of a flax-layout spec."""
    return {axis: _torch_dim(d, ndim, kernel) for d, axis in enumerate(spec) if axis}


class ShardedModel:
    """A model placed on a mesh (``shard_params``): its parameters cut to the
    rank's Megatron slices, then wrapped in DDP over 'data' or, with
    ``fsdp``, sharded by FSDP2 over 'data'.

    ``net`` is what a training forward calls (the DDP wrapper, or the model);
    ``leaves()`` / ``grads()`` give each parameter's and gradient's local
    storage (what the fused AdamW kernel and the EMA update in place);
    ``full_state(tensors)`` gathers tensors laid out like the leaves into full
    ones (every rank takes part), ``local(full)`` cuts full tensors to this
    rank's storage; ``norm_weights()`` is, per leaf, 1 / its number of
    copies on the mesh, so one all-reduce of the weighted sums of squares
    counts every element once."""

    def __init__(self, model: nn.Module, mesh: Mesh, fsdp: bool = False):
        self.model, self.mesh, self.fsdp = model, mesh, fsdp
        self.n_data, self.n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        self.i_data, self.i_model = mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS)
        full = _shapes(model)
        self.names: List[str] = list(full)
        self.full_shapes = full
        self.tp_dim: Dict[str, Optional[int]] = {}
        self.dp_dim: Dict[str, Optional[int]] = {}
        self.heads_grouped = set()
        for name, spec in param_shardings(full, mesh, fsdp).items():
            path, fshape, kernel = _flax_leaf(name, full[name])
            dims = _dims(spec, len(fshape), kernel)
            self.tp_dim[name] = dims.get(MODEL_AXIS) if mesh.tensor_parallel else None
            self.dp_dim[name] = dims.get(DATA_AXIS)
            if path.endswith('attn/qkv/kernel'):
                self.heads_grouped.add(name)
        model.to(mesh.device)
        if mesh.tensor_parallel:
            self._apply_tp()
        self.ddp = None
        # leaves the JAX rule keeps whole over 'data' (on one data rank FSDP2
        # holds every leaf, one shard being the whole)
        self.ignored = ({n for n in self.names if self.dp_dim[n] is None}
                        if fsdp and self.n_data > 1 else set())
        if fsdp:
            self._fully_shard()
        else:
            from torch.nn.parallel import DistributedDataParallel
            self.ddp = DistributedDataParallel(
                model, process_group=mesh.group(DATA_AXIS), broadcast_buffers=False,
                device_ids=[mesh.device.index] if mesh.device.type == 'cuda' else None)
        self.net = self.ddp if self.ddp is not None else model

    # ------------------------------------------------------------ placement
    def tp_slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's Megatron slice of the full tensor ``t`` of ``name``."""
        dim = self.tp_dim[name]
        if dim is None:
            return t
        n, i = self.n_model, self.i_model
        if name in self.heads_grouped:
            # (..., 3 * H * D, d) as (..., 3, H, D * d): q, k, v rows, head by head
            h = self.model.get_submodule(name.rsplit('.', 2)[0]).cfg.num_attention_heads
            v = t.reshape(*t.shape[:-2], 3, h, -1)
            if h % n:
                raise ValueError(f'{name}: {h} heads do not split over {n} model ranks')
            v = v[..., i * (h // n):(i + 1) * (h // n), :]
            return v.reshape(*t.shape[:-2], -1, t.shape[-1]).contiguous()
        if t.shape[dim] % n:
            raise ValueError(f'{name}: dim {dim} of {tuple(t.shape)} does not split over '
                             f'{n} model ranks')
        return t.chunk(n, dim)[i].contiguous()

    def tp_join(self, name: str, parts: List[torch.Tensor]) -> torch.Tensor:
        """Inverse of ``tp_slice``: the model ranks' slices, in rank order."""
        if name in self.heads_grouped:
            shape = parts[0].shape
            views = [p.reshape(*shape[:-2], 3, -1, shape[-1]) for p in parts]
            return torch.cat(views, dim=-2).reshape(*shape[:-2], -1, shape[-1])
        return torch.cat(parts, dim=self.tp_dim[name])

    def _apply_tp(self) -> None:
        """Cut every model-sharded parameter to the rank's slice and tell its
        module which Megatron role it plays."""
        from ..models.moe import MoeMlp
        from ..models.vit import Dense, Mlp, ScannedBlocks, SelfAttention
        with torch.no_grad():
            for name in self.names:
                if self.tp_dim[name] is None:
                    continue
                owner, _, leaf = name.rpartition('.')
                mod = self.model.get_submodule(owner)
                old = getattr(mod, leaf)
                mod.register_parameter(leaf, nn.Parameter(self.tp_slice(name, old.detach())))
        roles = {}
        for mname, mod in self.model.named_modules():
            if isinstance(mod, Dense) and self.tp_dim.get(f'{mname}.weight') is not None:
                if mname.endswith(('attn.qkv', 'mlp.fc1')):
                    roles[mname] = 'col'
                elif mname.endswith(('attn.out', 'mlp.fc2')):
                    roles[mname] = 'row'
                else:
                    roles[mname] = 'gather'
        for mname, mod in self.model.named_modules():
            if mname in roles:
                mod.tp = roles[mname]
            elif isinstance(mod, SelfAttention) and f'{mname}.qkv' in roles:
                mod.heads = mod.cfg.num_attention_heads // self.n_model
            elif isinstance(mod, Mlp) and f'{mname}.fc1' in roles:
                mod.tp = True
            elif isinstance(mod, MoeMlp) and self.tp_dim.get(f'{mname}.w1') is not None:
                mod.ep = True
        for mname, mod in self.model.named_modules():
            if isinstance(mod, ScannedBlocks):   # its template runs the layers
                for tname, tmod in mod.template.named_modules():
                    real = mod.get_submodule(tname)
                    for attr in ('tp', 'heads'):
                        if hasattr(real, attr):
                            setattr(tmod, attr, getattr(real, attr))

    def _fully_shard(self) -> None:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard
        from ..models.vit import Block, ScannedBlocks
        by_param = {id(p): n for n, p in self.model.named_parameters()}
        ignored = {p for n, p in self.model.named_parameters() if n in self.ignored}

        def placement(p):
            dim = self.dp_dim[by_param[id(p)]]
            return Shard(0 if dim is None else dim)
        data_mesh = self.mesh.device_mesh[DATA_AXIS]
        for mod in self.model.modules():
            # a unit per block that is called (the scanned stack's layers run
            # through its template, outside its hooks: the root holds it)
            if (isinstance(mod, Block) and not isinstance(mod, ScannedBlocks)
                    and any(p not in ignored for p in mod.parameters())):
                fully_shard(mod, mesh=data_mesh, shard_placement_fn=placement,
                            ignored_params=ignored)
        # the root keeps its leaves gathered from its forward to its backward
        # (FSDP2 finds no tensor to hook in a dataclass output); ``reshard``
        # after a forward without backward
        fully_shard(self.model, mesh=data_mesh, shard_placement_fn=placement,
                    ignored_params=ignored)

    # ------------------------------------------------------------- storage
    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.model.named_parameters())

    @staticmethod
    def _local(t):
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            with torch.no_grad():
                return t.to_local()
        return t

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Each parameter's local storage (updated in place by the step)."""
        return {k: self._local(p) for k, p in self.params().items()}

    def grads(self) -> Dict[str, torch.Tensor]:
        """Each parameter's local gradient (after ``sync_grads``)."""
        return {k: self._local(p.grad) for k, p in self.params().items()}

    def no_sync(self, sync: bool):
        """The context of one microbatch's backward: gradients are averaged
        over 'data' only when ``sync`` (the last microbatch)."""
        import contextlib
        if self.ddp is not None:
            return contextlib.nullcontext() if sync else self.ddp.no_sync()
        self.model.set_requires_gradient_sync(sync)
        return contextlib.nullcontext()

    def reshard(self) -> None:
        """After a forward without backward (evaluation): every leaf back to
        its shard (FSDP2's root keeps its gathered leaves until a backward)."""
        if self.fsdp:
            self.model.reshard()

    def sync_grads(self) -> None:
        """After the last backward: average the FSDP-ignored leaves'
        gradients over 'data' (DDP and FSDP2 did the rest)."""
        if not self.ignored or self.n_data == 1:
            return
        group = self.mesh.group(DATA_AXIS)
        params = self.params()
        for name in self.names:
            if name in self.ignored:
                g = params[name].grad
                dist.all_reduce(g, group=group)
                g.div_(self.n_data)

    def norm_weights(self) -> List[float]:
        """Per leaf (in ``names`` order), 1 / its number of identical copies
        on the mesh: replicated over 'data' unless FSDP shards it, over
        'model' unless the Megatron plan does."""
        out = []
        for name in self.names:
            copies = 1
            if not self.fsdp or name in self.ignored:
                copies *= self.n_data
            if self.tp_dim[name] is None:
                copies *= self.n_model
            out.append(1.0 / copies)
        return out

    def local(self, full: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors (one per name) cut to this rank's storage: the
        Megatron slice, then the FSDP chunk.  No communication."""
        out = {}
        for name in self.names:
            t = self.tp_slice(name, full[name])
            d = self.dp_dim[name]
            if self.fsdp and d is not None:
                t = t.chunk(self.n_data, d)[self.i_data]
            out[name] = t.contiguous()
        return out

    def load_full(self, full: Mapping[str, torch.Tensor]) -> None:
        """Write full parameters (a state_dict of the unsharded model) into
        the rank's storage."""
        mine = self.local(full)
        with torch.no_grad():
            for name, leaf in self.leaves().items():
                leaf.copy_(mine[name])

    def full_state(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors laid out like the leaves (the params, Adam's moments, the
        EMA) gathered into full tensors on the CPU, on every rank (a
        collective: every rank calls it with the same names)."""
        from torch.distributed.tensor import DTensor
        params = self.params()
        out = {}
        for name in self.names:
            t = tensors[name].detach()
            p = params[name]
            if isinstance(p, DTensor):
                t = DTensor.from_local(t, p.device_mesh, p.placements, shape=p.shape,
                                       stride=p.stride()).full_tensor()
            if self.tp_dim[name] is not None and self.n_model > 1:
                parts = [torch.empty_like(t) for _ in range(self.n_model)]
                dist.all_gather(parts, t.contiguous(), group=self.mesh.group(MODEL_AXIS))
                t = self.tp_join(name, parts)
            out[name] = t.to('cpu', copy=True)
        return out


def shard_params(model: nn.Module, mesh: Mesh, fsdp: bool = False) -> ShardedModel:
    """Place ``model`` (full, identical on every rank) on ``mesh`` by the
    partition rules: Megatron slices over 'model', then DDP or (``fsdp``)
    FSDP2 over 'data'."""
    return ShardedModel(model, mesh, fsdp)
