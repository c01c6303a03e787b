"""Frozen configuration dataclasses for the model and for training.

``VitConfig`` and ``TrainConfig`` are field-for-field copies of the JAX
package's, so a configuration carries over with
``VitConfig(**dataclasses.asdict(cfg))`` (likewise ``TrainConfig``).  Fields
whose feature the port has not reached yet keep their defaults: the model
raises on a ``VitConfig`` value it cannot honour (MoE, ``scan_blocks``,
``ring_axis``, ``remat``), and ``TrainConfig`` raises on construction for
its own (meshes, FSDP, multi-step dispatch, the linear probe, the optax
chain, async checkpoints, sub-f32 resident splits).  ``prng_impl`` and
``jax_debug_nans`` configure JAX alone and are carried, unread, so that a
JAX configuration still loads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    dropout_impl: str = 'flax'      # training dropout masks: 'flax' draws a
                                    # Bernoulli mask from the trainer's device
                                    # generator; 'hash' is the counter-hash
                                    # mask of ops/dropout.py (bit-equal to JAX)
    remat: bool = False             # activation recompute (not ported)
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
    """Training hyper-parameters (defaults from reference models/train.py:407-427).

    The JAX package's field comments give the reasons behind each default;
    here they say what the port does with the field."""
    num_train_epoch: int = 3
    train_batch_size: int = 64
    eval_batch_size: int = 64       # every eval/predict batch is padded to this size
    do_eval: bool = True
    optimizer: str = 'AdamW'        # 'AdamW' | 'Adam' (weight decay 0)
    learning_rate: float = 3e-4
    weight_decay: float = 1e-2
    warmup_ratio: float = 0.05
    schedule: str = 'cosine'        # 'cosine' | 'constant'
    grad_clip_norm: float = 1.0     # global-norm clip (reference train.py:281)
    n_sample: Optional[int] = None
    augment_timeout: bool = False   # TimeOut on training batches (ops/augment.py)
    patience: int = 8               # eval epochs without a better loss before stopping
    precision: str = 'bf16'         # carried; the compute dtype is VitConfig.dtype
    prng_impl: str = 'rbg'          # JAX only: ignored
    adam_mu_dtype: Optional[str] = None  # Adam's first moment: None (f32) | 'bfloat16'
    fused_optimizer: bool = True    # the fused AdamW step (ops/csrc/adamw.cu);
                                    # False (the optax chain) is not ported
    log_per_epoch: bool = False     # log the train metrics once per epoch
                                    # (each logged step syncs the device)
    epoch_scan: bool = False        # not ported
    steps_per_dispatch: int = 1     # not ported (1 only)
    resident_dtype: Optional[str] = None  # not ported (None: f32 splits)
    grad_accum: int = 1             # microbatches per optimizer step; must
                                    # divide train_batch_size
    ema_decay: float = 0.0          # >0: EMA of the params, served by evaluate/predict
    log_to_console: bool = True
    save_every_n_epoch: int = 0     # 0 = only save at the end
    save_final: bool = True         # save ckpt-final when train() returns
    async_checkpoint: bool = False  # not ported
    seed: int = 77                  # init, dropout and shuffle seed
                                    # (reference config.json 'random-seed')
    debug_nans: bool = True         # zero a step whose gradient norm is not
                                    # finite, count it on the device, and
                                    # raise at the next host sync
    jax_debug_nans: bool = False    # JAX only: ignored
    loss_weight: Optional[Tuple[float, float]] = None  # (w_neg, w_pos) BCE weights
    linear_probe: bool = False      # not ported
    device_resident: Optional[bool] = None  # keep the split on the device and
                                    # gather batches by index; None = when it
                                    # fits hbm_split_max_bytes
    hbm_split_max_bytes: int = 4 << 30
    mesh_data: Optional[int] = None  # not ported (one device)
    mesh_model: int = 1             # not ported (1 only)
    mesh_stage: int = 1             # not ported (1 only)
    fsdp: bool = False              # not ported

    def __post_init__(self):
        unported = {'mesh_data': self.mesh_data not in (None, 1),
                    'mesh_model': self.mesh_model != 1,
                    'mesh_stage': self.mesh_stage != 1,
                    'fsdp': self.fsdp,
                    'epoch_scan': self.epoch_scan,
                    'steps_per_dispatch': self.steps_per_dispatch != 1,
                    'linear_probe': self.linear_probe,
                    'fused_optimizer': not self.fused_optimizer,
                    'async_checkpoint': self.async_checkpoint,
                    'resident_dtype': self.resident_dtype is not None}
        if any(unported.values()):
            raise NotImplementedError(
                f'not ported: {[k for k, v in unported.items() if v]}')

    def steps_per_epoch(self, n_train: int) -> int:
        # floor: the trainer drops the last partial batch (the reference's
        # ceil(a // b) quirk, train.py:433, is not kept)
        return max(1, n_train // self.train_batch_size)

    def total_steps(self, n_train: int) -> int:
        return self.steps_per_epoch(n_train) * self.num_train_epoch
