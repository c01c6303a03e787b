"""Portable serving artifacts: the whole inference program as a ``torch.export``
program (the JAX package's ``models/export_artifact.py``, which writes
StableHLO).

The program is the JAX ``_infer_fn``: raw (B, C, L) float32 at 250 Hz ->
z-normalization with the trainer's statistics -> the always-pad
``time_end_pad`` -> the ViT forward on the served weights (the EMA when
tracked) -> a sigmoid in float32.  The weights are in the artifact; the batch
is a ``torch.export.Dim``, so one artifact serves any request size, and the
signal length is static (the wire length, chosen at export).

Flash attention enters the graph as the registered op
``ecg_tpu_torch::flash_fwd`` (``ops/attention.py``; kernel #1 on the GPU, its
plain version on the CPU).  Loading an artifact needs that op registered, so
``ExportedModel.load`` imports ``ops.attention``; it needs no model code,
config or checkpoint.  That is the counterpart of the JAX artifact running on
any XLA runtime.

``int8=True`` stores the quantized Linear weights and their per-output-channel
scales (``models/quantize.py``) as int8 and float32 buffers of the program,
and the dequantization (``q.float() * s`` per layer) stays in the graph, so the
artifact shrinks about 4x.

A program is traced on the trainer's device.  ``platforms`` lists the
devices it is checked on at export (the program moved there with
``torch.export.passes.move_to_device_pass`` and held against the eager
program); ``ExportedModel.load`` moves it to the device asked for (a loaded
program's tensors come back on the CPU) and refuses one the metadata does
not list.

Layout on disk (a directory):
  model.pt2      -- ``torch.export.save`` of the program (weights inside)
  metadata.json  -- model config, wire shapes, class codes and descriptions,
                    normalization stats, platforms, torch version, bytes

A Switch-MoE model is refused: its expert capacity ceil(cf * B * T / E)
depends on the batch, which is symbolic here (the JAX export raises too).
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.pad import time_end_pad
from ..runtime import default_device

ARTIFACT_VERSION = 1
_MODEL_FILE = 'model.pt2'
_META_FILE = 'metadata.json'
# the exported program against the eager one at export, per platform
_CHECK_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_DEBUG_META = ('stack_trace', 'nn_module_stack', 'source_fn_stack', 'torch_fn')
_LOAD_NEEDS = ('the op ecg_tpu_torch::flash_fwd, registered by importing '
               'ecg_representation_learning_tpu_torch.ops.attention; no model code, '
               'config or checkpoint')


class _InferProgram(nn.Module):
    """The serving program (the JAX ``_infer_fn``).  With ``int8`` the
    quantized leaves live as int8 buffers ``int8_q_<leaf>`` and float32
    buffers ``int8_s_<leaf>`` on their layers, in place of the float
    weights, and each forward dequantizes them in the graph."""

    def __init__(self, model: nn.Module, mean: torch.Tensor, std: torch.Tensor,
                 patch_size: int, int8: bool = False):
        super().__init__()
        self.model = model.eval()
        self.register_buffer('mean', mean.detach().float().reshape(-1, 1).clone())
        self.register_buffer('std', std.detach().float().reshape(-1, 1).clone())
        self.patch_size = patch_size
        self.int8_keys = []
        if int8:
            from .quantize import quantize_int8
            qweights, scales = quantize_int8(dict(model.named_parameters()))
            for key, q in qweights.items():
                owner, _, leaf = key.rpartition('.')
                layer = model.get_submodule(owner)
                layer.register_parameter(leaf, None)
                layer.register_buffer(f'int8_q_{leaf}', q)
                layer.register_buffer(f'int8_s_{leaf}', scales[key])
                self.int8_keys.append(key)

    def _int8(self):
        if not self.int8_keys:
            return contextlib.nullcontext()
        from .quantize import int8_weights
        q, s = {}, {}
        for key in self.int8_keys:
            owner, _, leaf = key.rpartition('.')
            q[key] = self.model.get_buffer(f'{owner}.int8_q_{leaf}')
            s[key] = self.model.get_buffer(f'{owner}.int8_s_{leaf}')
        return int8_weights(self.model, q, s)

    def forward(self, signals: torch.Tensor) -> torch.Tensor:
        sig = (signals - self.mean) / self.std
        sig = time_end_pad(sig, self.patch_size)
        with self._int8():
            out = self.model(sig)
        return torch.sigmoid(out.logits.float())


def export_model(
    trainer,
    path: str,
    signal_length: Optional[int] = None,
    int8: bool = False,
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export ``trainer``'s served model (the EMA weights when tracked, int8
    when asked) as a ``torch.export`` artifact at ``path``.

    ``signal_length`` is the wire length L of requests (default: the model's
    input minus one patch, so the always-pad lands on ``max_signal_length``).
    ``platforms`` ('cuda', 'cpu') are the devices the program is checked on
    and may be loaded on; default: the trainer's device.  Returns the
    metadata dict."""
    from ..registry import PTBXL_CODE2DESCRIPTION, PTBXL_ID2CODE
    cfg = trainer.model_cfg
    if not trainer.initialized:
        raise RuntimeError('trainer has no params: init/load a checkpoint first')
    if cfg.moe_num_experts > 0:
        raise ValueError('a Switch-MoE model cannot be exported with a symbolic batch: '
                         'its expert capacity ceil(cf * B * T / E) depends on the batch')
    L = signal_length or (cfg.max_signal_length - cfg.patch_size)
    # time_end_pad always pads (a full extra patch when L is already a
    # multiple): the padded length must not exceed the position table
    padded = L + (cfg.patch_size - L % cfg.patch_size
                  if L % cfg.patch_size else cfg.patch_size)
    assert padded <= cfg.max_signal_length, \
        f'signal_length {L} pads to {padded} > max_signal_length ' \
        f'{cfg.max_signal_length}'
    dev = trainer.device
    platforms = list(platforms or [dev.type])
    for p in platforms:
        if p not in ('cuda', 'cpu'):
            raise ValueError(f"platforms are 'cuda' and 'cpu', got {p!r}")

    program = _InferProgram(trainer.served_model(), trainer.mean, trainer.std,
                            cfg.patch_size, int8=int8).to(dev)
    # traced at batch 2: a sample batch of 1 would specialize the dimension
    sample = torch.zeros((2, cfg.num_channels, L), dtype=torch.float32, device=dev)
    batch = torch.export.Dim('batch', min=1, max=1 << 16)
    with torch.no_grad():
        exported = torch.export.export(program, (sample,),
                                       dynamic_shapes={'signals': {0: batch}}, strict=False)
        _check_platforms(program, exported, platforms, cfg, L)

    n_code = len(PTBXL_ID2CODE)
    meta = {
        'artifact_version': ARTIFACT_VERSION,
        'model': trainer.name,
        'model_config': {
            'size': getattr(cfg, 'size', None),
            'num_class': cfg.num_class,
            'num_channels': cfg.num_channels,
            'max_signal_length': cfg.max_signal_length,
            'patch_size': cfg.patch_size,
        },
        'wire': {'signal_length': L, 'dtype': 'float32',
                 'layout': '(batch, leads, samples) @ 250 Hz raw',
                 'batch': 'symbolic'},
        'output': {'shape': f'(batch, {cfg.num_class})',
                   'semantics': 'per-class sigmoid probabilities'},
        'classes': [
            {'id': i, 'code': PTBXL_ID2CODE[i],
             'description': PTBXL_CODE2DESCRIPTION.get(PTBXL_ID2CODE[i], '')}
            for i in range(min(cfg.num_class, n_code))
        ],
        'norm_stats': {'mean': trainer.mean.cpu().tolist(),
                       'std': trainer.std.cpu().tolist()},
        'int8': bool(int8),
        'weights_file': None,
        'platforms': platforms,
        'traced_on': dev.type,
        'load_needs': _LOAD_NEEDS,
        'torch_version': torch.__version__,
    }
    # the nodes' source stack traces and module stacks (for
    # torch.export.unflatten) are most of the serialized graph and not
    # needed to run it
    for node in exported.graph.nodes:
        for key in _DEBUG_META:
            node.meta.pop(key, None)
    os.makedirs(path, exist_ok=True)
    model_file = os.path.join(path, _MODEL_FILE)
    torch.export.save(exported, model_file)
    meta['bytes'] = os.path.getsize(model_file)
    with open(os.path.join(path, _META_FILE), 'w') as f:
        json.dump(meta, f, indent=1)
    return meta


def _check_platforms(program, exported, platforms, cfg, length: int) -> None:
    """Run the exported program on each platform and hold it against the
    eager program on the trainer's device (``_CHECK_TOL`` of the model's
    compute dtype)."""
    from torch.export.passes import move_to_device_pass
    dev = program.mean.device
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, cfg.num_channels, length), generator=gen)
    want = program(x.to(dev)).cpu()
    tol = _CHECK_TOL[torch.bfloat16 if cfg.dtype == 'bfloat16' else torch.float32]
    for p in platforms:
        target = default_device(p)
        ep = exported if target.type == dev.type else move_to_device_pass(exported, p)
        got = ep.module()(x.to(target)).cpu()
        err = float((got - want).abs().max())
        if got.shape != want.shape or not err <= tol:
            raise RuntimeError(f'the exported program on {p} is {err} from the eager '
                               f'program (limit {tol})')


class ExportedModel:
    """Load and run an artifact.  Everything it needs is in the two files and
    the port's registered op: no model code, checkpoint or config."""

    def __init__(self, program, metadata: Dict[str, Any], device: torch.device):
        self.program = program
        self.module = program.module()
        self.metadata = metadata
        self.device = device
        self.num_channels = metadata['model_config']['num_channels']
        self.signal_length = metadata['wire']['signal_length']

    @classmethod
    def load(cls, path: str, device=None) -> 'ExportedModel':
        """The artifact at ``path`` on ``device`` (default: the GPU), which
        must be one of the metadata's ``platforms``."""
        from ..ops import attention  # noqa: F401  registers ecg_tpu_torch::flash_fwd
        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        assert meta.get('artifact_version') == ARTIFACT_VERSION, \
            f"artifact version {meta.get('artifact_version')} != {ARTIFACT_VERSION}"
        dev = torch.device('cuda' if device is None else device)
        if dev.type not in meta['platforms']:
            raise ValueError(f"the artifact was checked on {meta['platforms']}, not "
                             f'{dev.type}: re-export with platforms including it')
        dev = default_device(dev)
        from torch.export.passes import move_to_device_pass
        # a loaded program's tensors may be on the CPU whatever the device it
        # was traced on: move all of them, and the devices its nodes name
        program = move_to_device_pass(torch.export.load(os.path.join(path, _MODEL_FILE)),
                                      dev.type)
        return cls(program, meta, dev)

    @torch.no_grad()
    def predict(self, signals: np.ndarray) -> np.ndarray:
        """Raw (N, C, L) or (C, L) float32 -> (N, num_class) probabilities.
        Shorter records are padded to the wire length with the per-lead
        normalization MEAN: the program z-normalizes before its own
        time_end_pad, so mean-valued samples normalize to exactly the zero
        tail training saw (raw zeros would become -mean/std under non-zero
        stats, e.g. --stats original)."""
        sig = np.asarray(signals, np.float32)
        if sig.ndim == 2:
            sig = sig[None]
        assert sig.ndim == 3 and sig.shape[1] == self.num_channels, \
            f'want (N, {self.num_channels}, L), got {sig.shape}'
        L = self.signal_length
        assert sig.shape[2] <= L, \
            f'record length {sig.shape[2]} > wire length {L}: window it ' \
            f'(Trainer.predict_long) or re-export with a larger signal_length'
        if sig.shape[2] < L:
            mean = np.asarray(self.metadata['norm_stats']['mean'],
                              np.float32).reshape(1, -1, 1)
            tail = np.broadcast_to(
                mean, (sig.shape[0], sig.shape[1], L - sig.shape[2]))
            sig = np.concatenate([sig, tail], axis=2)
        x = torch.from_numpy(np.ascontiguousarray(sig)).to(self.device)
        return self.module(x).cpu().numpy()
