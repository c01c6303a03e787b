"""The benchmark's inputs, made from the run's seed: model weights, the
PTB-XL-shaped training split and the streaming corpora's shard files.

Everything is drawn on the run's device with one ``torch.Generator`` per
input and in a few large calls, so set-up stays short and the same seed gives
the same inputs.  Every seed gives the same sizes.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# one stream per input, so adding an input never moves another's draws
_WEIGHTS, _SIGNALS, _LABELS, _SHARDS = 0x5EED01, 0x5EED02, 0x5EED03, 0x5EED04


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + stream) % (1 << 63))
    return g


def weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 parameters for ``shapes`` from one normal draw n: a matrix
    n / sqrt(fan in), a LayerNorm scale 1 + 0.02 n, every other leaf
    (biases, tokens, position embeddings) 0.02 n."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, _WEIGHTS, device), device=device)
    out, pos = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[pos:pos + n].view(shape)
        pos += n
        if len(shape) == 2:
            w.mul_(1.0 / math.sqrt(shape[-1]))
        elif len(shape) == 1 and name.endswith('.weight'):    # a LayerNorm scale
            w.mul_(0.02).add_(1.0)
        else:
            w.mul_(0.02)
        out[name] = w
    return out


def ecg_waves(n: int, leads: int, length: int, fqs: float, gen: torch.Generator,
              device) -> torch.Tensor:
    """(n, leads, length) f32 ECG-like signals in mV: a heartbeat of five
    harmonics at 0.8-1.8 Hz with per-lead gains and signs, baseline wander
    and white noise."""
    t = torch.arange(length, device=device, dtype=torch.float32) / fqs
    hr = 0.8 + torch.rand((n, 1, 1), generator=gen, device=device)
    phase = 2 * math.pi * torch.rand((n, 1, 1), generator=gen, device=device)
    gain = (0.4 + 1.2 * torch.rand((n, leads, 1), generator=gen, device=device)) * torch.where(
        torch.rand((n, leads, 1), generator=gen, device=device) < 0.2, -1.0, 1.0)
    x = torch.zeros((n, leads, length), device=device)
    for k, a in enumerate((0.6, 0.35, 0.2, 0.12, 0.07), start=1):
        x += a * torch.sin(2 * math.pi * k * hr * t + k * phase)
    x *= gain
    wander = 0.1 * torch.sin(2 * math.pi * 0.2 * t + 6 * torch.rand(
        (n, 1, 1), generator=gen, device=device))
    return x + wander + 0.03 * torch.randn((n, leads, length), generator=gen, device=device)


def ptbxl_split(n: int, leads: int, length: int, classes: int, seed: int, device,
                chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """A training split of ``n`` records (n, leads, length) at 250 Hz in f32
    and multi-hot labels (n, classes) in f32, PTB-XL-like: class j present
    with probability 0.3 * 0.93^j, at least one class a record."""
    gen = generator(seed, _SIGNALS, device)
    sig = torch.empty((n, leads, length), device=device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        sig[lo:hi] = ecg_waves(hi - lo, leads, length, 250.0, gen, device)
    lg = generator(seed, _LABELS, device)
    prev = 0.3 * 0.93 ** torch.arange(classes, device=device, dtype=torch.float32)
    labels = (torch.rand((n, classes), generator=lg, device=device) < prev).float()
    empty = labels.sum(dim=1) == 0
    labels[empty, classes - 1] = 1.0
    return sig, labels


def write_shards(root: str, corpora: Sequence[dict], leads: int, wire_scale: float,
                 seed: int, device) -> List[List[str]]:
    """One directory per corpus under ``root``, each with its shards as
    int16 ``.npy`` files of ECG-like records at the corpus's native rate
    (counts = mV * ``wire_scale``).  Returns the shard paths per corpus."""
    gen = generator(seed, _SHARDS, device)
    out = []
    for c in corpora:
        d = os.path.join(root, c['name'])
        os.makedirs(d, exist_ok=True)
        paths = []
        for s in range(c['shards']):
            x = ecg_waves(c['records_per_shard'], leads, c['samples'], float(c['fqs']), gen,
                          device)
            counts = torch.round(x * wire_scale).clamp(-32768, 32767).to(torch.int16)
            path = os.path.join(d, f'shard-{s:03d}.npy')
            np.save(path, counts.cpu().numpy())
            paths.append(path)
        out.append(paths)
    return out
