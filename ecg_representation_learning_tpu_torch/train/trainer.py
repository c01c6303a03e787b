"""The inference half of the JAX package's ``Trainer``: init, predict, predict_long.

Per batch, as the JAX ``eval_step`` does: z-normalize with the per-lead
statistics, ``time_end_pad`` to the next patch multiple, forward, sigmoid.
Every batch is padded to ``eval_batch_size`` (with copies of row 0) and
trimmed, so the device always sees one batch shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs import TrainConfig, VitConfig
from ..models.vit import EcgVit
from ..ops.pad import time_end_pad
from ..runtime import default_device
from ..utils.logging import get_logger


@dataclasses.dataclass
class SplitData:
    """One split: raw signals + multi-hot labels."""
    signals: np.ndarray   # (N, C, L) float32, unnormalized (raw 250 Hz grid)
    labels: np.ndarray    # (N, num_class) float32 multi-hot

    def __len__(self):
        return self.signals.shape[0]


def _prep_batch(sig: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                patch_size: int) -> torch.Tensor:
    """Eval-time per-batch transform: normalize -> pad."""
    sig = (sig - mean.reshape(-1, 1)) / std.reshape(-1, 1)
    return time_end_pad(sig, patch_size)


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init: truncated normal (at +-2 std) with
    variance 1/fan_in after truncation."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class Trainer:
    """Serving-side counterpart of the JAX ``Trainer`` (no training yet)."""

    def __init__(self, model_cfg: VitConfig, train_cfg: TrainConfig,
                 norm_stats: Optional[Dict[str, Any]] = None,
                 name: str = 'EcgVit', device=None):
        self.device = default_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.name = name
        self.model = EcgVit(model_cfg).eval()
        stats = norm_stats or {'mean': [0.0] * model_cfg.num_channels,
                               'std': [1.0] * model_cfg.num_channels}
        self.mean = torch.tensor(stats['mean'], dtype=torch.float32, device=self.device)
        self.std = torch.tensor(stats['std'], dtype=torch.float32, device=self.device)
        self.initialized = False
        self.logger = get_logger(f'{name} Train')

    def init_state(self, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Seeded init with flax's distributions: lecun-normal Linear weights,
        zero biases, unit LayerNorm scales, normal(0.02) cls and pos tokens.
        Drawn on the CPU from one ``torch.Generator``, so the weights do not
        depend on the device."""
        gen = torch.Generator().manual_seed(self.cfg.seed if seed is None else seed)
        self.model.to('cpu')
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if name.endswith(('cls_token', 'pos_embed')):
                    torch.nn.init.normal_(p, 0.0, 0.02, generator=gen)
                elif name.endswith('bias'):
                    p.zero_()
                elif p.dim() == 2:
                    _lecun_normal_(p, gen)
                else:
                    p.fill_(1.0)
        self.model.to(self.device)
        self.initialized = True
        self._log(f'initialized {self.model_cfg.meta} on {self.device}')
        return self.model.state_dict()

    def set_params(self, state_dict: Mapping[str, torch.Tensor]):
        """Install an externally built state_dict (e.g. flax params carried
        over with ``models.port.vit_state_dict_from_flax``)."""
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device)
        self.initialized = True
        self._log(f'loaded weights into {self.model_cfg.meta} on {self.device}')
        return self.model.state_dict()

    def _log(self, msg: str) -> None:
        if self.cfg.log_to_console:
            self.logger.info(msg)

    def _index_batches(self, data: SplitData, batch_size: int, shuffle_rng=None,
                       drop_last: bool = True) -> Iterator[Tuple[np.ndarray, int]]:
        n = len(data)
        idx = np.arange(n)
        if shuffle_rng is not None:
            shuffle_rng.shuffle(idx)
        stop = (n // batch_size) * batch_size if drop_last else n
        for i in range(0, max(stop, 0), batch_size):
            take = idx[i:i + batch_size]
            n_real = take.size
            if n_real < batch_size:  # pad the final batch; trimmed on the host
                take = np.concatenate([take, np.zeros(batch_size - n_real, np.int64)])
            yield take, n_real

    @torch.inference_mode()
    def predict(self, signals: np.ndarray) -> np.ndarray:
        """Batch inference: per-record sigmoid probabilities (N, num_class)."""
        if not self.initialized:
            raise RuntimeError('call init_state() or set_params() first')
        data = SplitData(
            signals=np.asarray(signals, np.float32),
            labels=np.zeros((len(signals), self.model_cfg.num_class), np.float32))
        probs_all = []
        for take, n_real in self._index_batches(data, self.cfg.eval_batch_size,
                                                drop_last=False):
            sig = torch.from_numpy(data.signals[take]).to(self.device)
            sig = _prep_batch(sig, self.mean, self.std, self.model_cfg.patch_size)
            probs = torch.sigmoid(self.model(sig).logits.float())
            probs_all.append(probs[:n_real].cpu().numpy())
        return np.concatenate(probs_all)

    def predict_long(self, signals: np.ndarray, window: Optional[int] = None,
                     hop: Optional[int] = None, agg: str = 'max') -> np.ndarray:
        """Sliding-window inference on records longer than the model's input:
        window the signal, predict every window as one batch, aggregate the
        per-class probabilities ('max' or 'mean') across windows.

        ``window`` defaults to the model's input length minus one patch (the
        always-pad quirk), ``hop`` to window/2.  Shorter records go straight
        to :meth:`predict`.  Returns (N, num_class).
        """
        if agg not in ('max', 'mean'):
            raise ValueError(f"agg must be 'max' or 'mean', got {agg!r}")
        signals = np.asarray(signals, np.float32)
        if signals.ndim == 2:
            signals = signals[None]
        n, c, length = signals.shape
        explicit_window = window is not None
        window = window or (self.model_cfg.max_signal_length
                            - self.model_cfg.patch_size)
        hop = hop or max(1, window // 2)
        # predict() is lossless for any L < max_signal_length: time_end_pad
        # takes L to the next patch multiple, which stays <= max only while
        # L < max.  Only slide windows beyond that, or when asked to.
        direct = (length <= window if explicit_window
                  else length < self.model_cfg.max_signal_length)
        if direct:
            return self.predict(signals)
        starts = list(range(0, length - window + 1, hop))
        if starts[-1] + window < length:       # cover the tail remainder
            starts.append(length - window)
        windows = np.stack([signals[:, :, s:s + window] for s in starts],
                           axis=1)             # (N, W, C, window)
        flat = windows.reshape(n * len(starts), c, window)
        probs = self.predict(flat).reshape(n, len(starts), -1)
        return probs.max(axis=1) if agg == 'max' else probs.mean(axis=1)
