"""Weight-only int8 quantization for inference (the JAX package's
``models/quantize.py``).

The weights of the Linear layers are stored on the device as int8 with one
float32 scale per output channel; each layer dequantizes its weight when it
runs (``q.float() * s``, then the layer's compute dtype, as the JAX package
casts its dequantized f32 tree), so the Linear products stay in the model's
compute dtype and no activation is quantized.  The JAX package leaves the
dequantization to XLA, which fuses it into each product's operand read; here
it is one elementwise product per layer before cuBLAS.

Scheme (the JAX package's): symmetric per output channel, round half to
even, clipped to [-127, 127], scale floor 1e-12.  A leaf is quantized when
its flax path (``models.port.flax_path``) ends in ``kernel`` or is a MoE
expert stack (``moe/w1``, ``moe/w2``), and it has at least two dims and
``MIN_QUANT_SIZE`` elements: the Linear weights, ``head`` included, the
expert stacks, and the MoE router when d * E reaches the size.  LayerNorms,
biases, the cls token and the position embeddings stay float32.  A flax
kernel is (in, out) and JAX reduces axis -2; a torch ``Linear.weight`` is
(out, in), so the port reduces dim -1 and its int8 tensors and scales are
JAX's transposed.  The expert stacks keep the JAX layout, so their int8
tensors and scales (E, 1, f) are JAX's as they are.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Mapping, Tuple

import torch

from .moe import MoeMlp
from .port import flax_path

# leaves smaller than this stay unquantized (scales and padding would eat
# the saving; small tensors also carry outsized accuracy weight)
MIN_QUANT_SIZE = 4096


def _expert_stack(path) -> bool:
    return path[-2:] in (('moe', 'w1'), ('moe', 'w2'))


def quantizable(key: str, leaf: torch.Tensor) -> bool:
    """Whether the parameter ``key`` is stored as int8: a Dense kernel by its
    flax path (the MoE router's included) or a MoE expert stack, of at least
    2 dims and ``MIN_QUANT_SIZE`` elements."""
    path = flax_path(key)
    return (leaf.dim() >= 2 and leaf.numel() >= MIN_QUANT_SIZE
            and (path[-1] == 'kernel' or _expert_stack(path)))


def quantize_int8(state_dict: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """({key: int8 weight}, {key: f32 scales}) for the quantizable leaves of
    ``state_dict``, on their device.  A Linear weight (..., out, in) reduces
    its last dim (scales (..., out, 1)); an expert stack, in the JAX layout,
    reduces dim -2 as JAX does (``w1`` (E, d, f) -> scales (E, 1, f))."""
    qweights, scales = {}, {}
    for key, leaf in state_dict.items():
        if not quantizable(key, leaf):
            continue
        w = leaf.detach().float()
        dim = -2 if _expert_stack(flax_path(key)) else -1
        s = torch.clamp(w.abs().amax(dim=dim, keepdim=True) / 127.0, min=1e-12)
        qweights[key] = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        scales[key] = s
    return qweights, scales


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The float32 weight of an int8 tensor and its scales."""
    return q.float() * s


def quantized_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Total bytes of ``tensors`` (the serving-memory headline number)."""
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def int8_weights(model: torch.nn.Module, qweights: Mapping[str, torch.Tensor],
                 scales: Mapping[str, torch.Tensor]):
    """Within the block, each Linear of ``model`` whose weight is in
    ``qweights`` computes with its dequantized int8 weight instead of its
    own (``models.vit.Dense.int8``), and each MoE MLP with its dequantized
    int8 expert stacks (``models.moe.MoeMlp.int8``)."""
    layers = [(model.get_submodule(key.rsplit('.', 1)[0]), key) for key in qweights]
    try:
        for layer, key in layers:
            pair = (qweights[key], scales[key])
            if isinstance(layer, MoeMlp):
                layer.int8[key.rsplit('.', 1)[1]] = pair
            else:
                layer.int8 = pair
        yield model
    finally:
        for layer, _ in layers:
            if isinstance(layer, MoeMlp):
                layer.int8.clear()
            else:
                layer.int8 = None
