"""Frozen configuration dataclasses for the model and for inference.

``VitConfig`` is a field-for-field copy of the JAX package's, ladder included,
so a configuration carries over with ``VitConfig(**dataclasses.asdict(cfg))``.
Fields whose feature the port has not reached yet (MoE, ``scan_blocks``,
``ring_axis``, ``remat``, ``dropout_impl``) keep their defaults; the model
raises on a value it cannot honour.  ``TrainConfig`` holds only the fields
that inference reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .registry import PTBXL_N_CLASS


@dataclasses.dataclass(frozen=True)
class VitConfig:
    """1-D ViT configuration (reference ecg_vit.py:29-53 defaults)."""
    max_signal_length: int = 2560
    patch_size: int = 64
    num_channels: int = 12
    hidden_size: int = 512
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    num_class: int = PTBXL_N_CLASS
    pool: str = 'cls'               # 'cls' | 'mean'
    patch_norm: bool = True         # LayerNorm before/after the patch projection
                                    # (False: the reference vit-pytorch 0.33.2
                                    # layout)
    dtype: str = 'float32'          # compute dtype of the Linear layers
                                    # ('bfloat16' casts input and weight)
    use_flash_attention: bool = True
    flash_min_seq: int = 128        # below this sequence length attention runs
                                    # the plain path instead of the flash
                                    # kernel; 0 = always use the kernel.  The
                                    # default is the JAX package's and has not
                                    # been re-measured on the GPU.
    flash_interpret: bool = False   # JAX only (Pallas interpreter); ignored
    ring_axis: Optional[str] = None  # JAX only: context parallelism
    dropout_impl: str = 'flax'      # training dropout masks (training slice)
    remat: bool = False             # activation recompute (training slice)
    scan_blocks: bool = False       # JAX only: stacked-parameter layer scan
    size: Optional[str] = None      # name from the ladder, if built via from_defined
    moe_num_experts: int = 0        # Switch-MoE MLPs (not ported yet)
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def num_patches(self) -> int:
        assert self.max_signal_length % self.patch_size == 0
        return self.max_signal_length // self.patch_size

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_attention_heads == 0
        return self.hidden_size // self.num_attention_heads

    # the five named sizes of the reference ladder (ecg_vit.py:66-92)
    _SIZES = {
        'debug': dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                      intermediate_size=256),
        'tiny': dict(hidden_size=256, num_hidden_layers=4, num_attention_heads=4,
                     intermediate_size=1024),
        'small': dict(hidden_size=512, num_hidden_layers=8, num_attention_heads=8,
                      intermediate_size=2048),
        'base': dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                     intermediate_size=3072),
        'large': dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                      intermediate_size=4096),
    }

    @classmethod
    def from_defined(cls, model_name: str, **overrides) -> 'VitConfig':
        """Build a config from a ladder name like ``'ecg-vit-base'`` or ``'base'``."""
        size = model_name.split('-')[-1]
        if size not in cls._SIZES:
            raise ValueError(
                f'Unknown model size {size!r}; expected one of {sorted(cls._SIZES)}')
        return cls(size=size, **{**cls._SIZES[size], **overrides})

    @property
    def meta(self) -> dict:
        """Human-readable summary (mirrors the reference ``EcgVit.meta``)."""
        return {
            'name': 'EcgVit',
            'input shape': f'{self.num_channels} x {self.max_signal_length}',
            '#patch': self.num_patches,
            '#layer': self.num_hidden_layers,
            '#head': self.num_attention_heads,
        }


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The inference fields of the JAX package's ``TrainConfig``."""
    eval_batch_size: int = 64       # every predict batch is padded to this size
    seed: int = 77                  # init seed (reference config.json 'random-seed')
    log_to_console: bool = True
