"""Frozen configuration dataclasses for the model, training and preprocessing.

``VitConfig``, ``MaeConfig``, ``ContrastiveConfig`` and ``TrainConfig`` are
field-for-field copies of the JAX package's, so a configuration carries over
with ``VitConfig(**dataclasses.asdict(cfg))`` (likewise the others).  The
one-device model options are ported (Switch-MoE, ``remat``, ``scan_blocks``;
MoE with ``scan_blocks`` is refused, as in JAX), and so is
``async_checkpoint``, and multi-step dispatch (``epoch_scan``,
``steps_per_dispatch``: CUDA graphs of the step, ``train/dispatch.py``).
The parallel layouts are ported: ``mesh_data``, ``mesh_model`` and ``fsdp``
build the ('data', 'model') mesh (``parallel/``), ``mesh_stage`` the GPipe
pipeline (``train/pipeline_vit.py``), and ``VitConfig.ring_axis`` runs ring
context parallelism (``train/long_record.py``).
``DeepseekConfig``, a subclass of ``VitConfig`` with no JAX counterpart,
runs DeepSeek-V3's block on the same trunk, ``AfmoeConfig`` (a subclass of
it) Arcee's AFMoE block, and ``MODEL_PRESETS`` names
published blocks cut to one device's share (``VitConfig.from_preset``,
``cli train --model-preset``).
``prng_impl`` and ``jax_debug_nans`` configure JAX alone and are carried,
unread, so that a JAX configuration still loads.
``PreprocessConfig`` is a whole copy.
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
    ring_axis: Optional[str] = None  # context parallelism: the mesh axis the
                                    # sequence is split over (ring attention)
    dropout_impl: str = 'flax'      # training dropout masks: 'flax' draws a
                                    # Bernoulli mask from the trainer's device
                                    # generator; 'hash' is the counter-hash
                                    # mask of ops/dropout.py (bit-equal to JAX)
    remat: bool = False             # recompute each block's activations in the
                                    # backward (models/vit.py)
    scan_blocks: bool = False       # the blocks' parameters stacked (L, ...)
                                    # under one module (JAX's nn.scan tree)
    size: Optional[str] = None      # name from the ladder, if built via from_defined
    moe_num_experts: int = 0        # >0: Switch-MoE MLPs with this many
                                    # experts (models/moe.py)
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    @property
    def block(self) -> str:
        """The block kind: 'vit' here, 'deepseek' for ``DeepseekConfig``,
        'afmoe' for ``AfmoeConfig``."""
        return 'vit'

    def require_vit_block(self, what: str) -> None:
        """Raise ValueError where ``what`` cannot serve this block yet (every
        path but the supervised one-device step serves 'vit' alone)."""
        if self.block != 'vit':
            raise ValueError(f'{what} does not serve the {self.block!r} block yet '
                             f"(only block='vit')")

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
    def from_preset(cls, name: str, **overrides) -> 'VitConfig':
        """A configuration of ``MODEL_PRESETS`` (outside the reference ladder,
        each a ``DeepseekConfig``, or the class its 'block' names)."""
        if name not in MODEL_PRESETS:
            raise ValueError(f'Unknown model preset {name!r}; expected one of '
                             f'{sorted(MODEL_PRESETS)}')
        fields = dict(MODEL_PRESETS[name])
        kind = {'deepseek': DeepseekConfig, 'afmoe': AfmoeConfig}[fields.pop('block', 'deepseek')]
        return kind(**{**fields, **overrides})

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
class DeepseekConfig(VitConfig):
    """DeepSeek-V3's block on the ViT's trunk (``models/mla.py``,
    ``models/moe.py``'s ``DeepseekMoe``): RMSNorm, latent attention with
    decoupled RoPE positions (no learned table), SwiGLU MLPs, and from layer
    ``first_k_dense_replace`` on a MoE of ``moe_num_experts`` routed experts
    (sigmoid scores, top ``moe_top_k`` of score + correction bias, gates
    normalized and scaled), ``moe_shared_experts`` shared ones, dropless.  No
    dropout sites.  A subclass, so ``VitConfig`` keeps the JAX package's
    fields one for one."""
    kv_lora_rank: int = 512         # the latent keys and values come from
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64      # one rotary key shared by all heads
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    first_k_dense_replace: int = 1  # leading dense (SwiGLU) layers
    moe_intermediate_size: int = 1408  # width of each routed and shared expert
    moe_top_k: int = 6
    moe_routed_scale: float = 1.0   # routed_scaling_factor
    moe_shared_experts: int = 0
    moe_held: Optional[Tuple[int, int]] = None  # (first, count) of the routed
                                    # experts this device holds (expert
                                    # parallelism's share); None: all
    moe_bias_rate: float = 0.0      # aux-loss-free balancing: the correction
                                    # bias's step per optimizer step
    moe_seq_aux_weight: float = 0.0  # sequence-wise balance loss weight

    @property
    def block(self) -> str:
        return 'deepseek'


@dataclasses.dataclass(frozen=True)
class AfmoeConfig(DeepseekConfig):
    """Arcee's AFMoE block (Trinity, ``models/afmoe.py``) on the ViT's trunk:
    grouped-query attention of ``num_attention_heads`` query and
    ``num_key_value_heads`` KV heads of ``head_dim`` (not hidden / heads),
    per-head RMSNorm on q and k, a sigmoid output gate, causal when
    ``causal``; in each ``global_attn_every_n_layers`` layers the last one
    full attention without positions and the others a left window of
    ``sliding_window`` keys (the query's own and the ones before it) with
    RoPE; four RMSNorms a block; the patch embedding times sqrt(hidden) when
    ``mup``, no position table and no cls token.  The MLPs are
    ``DeepseekConfig``'s: ``first_k_dense_replace`` dense SwiGLU layers, then
    ``DeepseekMoe``."""
    num_key_value_heads: int = 4
    head_dim: int = 128             # a field here: the heads are not hidden / H
    sliding_window: int = 2048      # keys a sliding layer's query sees, its own included
    global_attn_every_n_layers: int = 4
    causal: bool = True
    mup: bool = True                # the embedding times sqrt(hidden_size)

    @property
    def block(self) -> str:
        return 'afmoe'

    def sliding(self, i: int) -> bool:
        """Whether layer ``i`` takes the window (and RoPE): all but every
        ``global_attn_every_n_layers``-th."""
        return (i + 1) % self.global_attn_every_n_layers != 0


# Published blocks on the ECG trunk (patch embedding, cls token, 71-class
# head), cut to one device's share of a stated deployment.
MODEL_PRESETS = {
    # Moonlight-16B-A3B (huggingface.co/moonshotai/Moonlight-16B-A3B,
    # config.json, DeepSeek-V3's block): 8-way expert parallel, this device
    # holding experts 0-7 of 64, stage 1 of 2 (layer 0 dense, 12 MoE layers)
    'moonlight-16b-a3b-ep8': dict(
        hidden_size=2048, num_hidden_layers=13, num_attention_heads=16,
        intermediate_size=11264, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, rope_theta=50000.0, rms_norm_eps=1e-5,
        first_k_dense_replace=1, moe_num_experts=64, moe_intermediate_size=1408,
        moe_top_k=6, moe_routed_scale=2.446, moe_shared_experts=2, moe_held=(0, 8),
        moe_bias_rate=1e-3, moe_seq_aux_weight=1e-4, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, dtype='bfloat16'),
    # Trinity-Mini (huggingface.co/arcee-ai/Trinity-Mini, config.json, Arcee's
    # AFMoE block): 16-way expert parallel, this device holding experts 0-7 of
    # 128, stage 1 of 2 (layers 0-15: 2 dense, 14 MoE; 12 sliding, 4 full),
    # causal attention over 35-minute records (524,288 samples, 8,192 patches)
    'trinity-mini-ep16': dict(
        block='afmoe', max_signal_length=524288, hidden_size=2048, num_hidden_layers=16,
        num_attention_heads=32, num_key_value_heads=4, head_dim=128,
        intermediate_size=6144, sliding_window=2048, global_attn_every_n_layers=4,
        rope_theta=10000.0, rms_norm_eps=1e-5, first_k_dense_replace=2,
        moe_num_experts=128, moe_intermediate_size=1024, moe_top_k=8,
        moe_routed_scale=2.826, moe_shared_experts=1, moe_held=(0, 8), moe_bias_rate=1e-3,
        moe_seq_aux_weight=0.0, pool='mean', hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, dtype='bfloat16'),
}


@dataclasses.dataclass(frozen=True)
class MaeConfig:
    """Masked-patch pretraining head (models/mae.py)."""
    mask_ratio: float = 0.75
    decoder_hidden_size: int = 256
    decoder_num_layers: int = 2
    decoder_num_heads: int = 4
    decoder_intermediate_size: int = 1024
    norm_patch_targets: bool = True  # normalize each target patch to zero-mean/unit-var


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    """SimCLR-style pretraining: NT-Xent over two stochastic views
    (models/contrastive.py, train/contrastive.py)."""
    temperature: float = 0.1
    proj_hidden_size: int = 512     # hidden width of the 2-layer projection MLP
    proj_dim: int = 128             # embedding dim the loss acts on
    # view-construction knobs (ops/augment.contrastive_view)
    scale_lo: float = 0.8
    scale_hi: float = 1.25
    jitter_sigma: float = 0.05
    lead_dropout: float = 0.2
    shift_frac: float = 0.5
    timeout_hi: float = 0.25


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
                                    # False: the optax chain's semantics in
                                    # plain PyTorch (train/optim.AdamChain)
    log_per_epoch: bool = False     # log the train metrics once per epoch
                                    # (each logged step syncs the device)
    epoch_scan: bool = False        # each epoch as one dispatch: on the GPU
                                    # replays of a CUDA graph of one step
                                    # that reads its tape row at a device
                                    # cursor (train/dispatch.py); wins over
                                    # steps_per_dispatch; needs a resident split
    steps_per_dispatch: int = 1     # K > 1: K steps a dispatch, on the GPU one
                                    # CUDA graph of K steps; leftover steps run
                                    # the single step.  Both bit-equal to the
                                    # per-step loop; both fall back to it when
                                    # the split is not resident
    resident_dtype: Optional[str] = None  # storage dtype of a resident split's
                                    # signals: None (f32) | 'float16' |
                                    # 'bfloat16'; cast to f32 after the gather
    grad_accum: int = 1             # microbatches per optimizer step; must
                                    # divide train_batch_size
    ema_decay: float = 0.0          # >0: EMA of the params, served by evaluate/predict
    log_to_console: bool = True
    save_every_n_epoch: int = 0     # 0 = only save at the end
    save_final: bool = True         # save ckpt-final when train() returns
    async_checkpoint: bool = False  # write checkpoints on a writer thread
                                    # (train/checkpoint.py)
    seed: int = 77                  # init, dropout and shuffle seed
                                    # (reference config.json 'random-seed')
    debug_nans: bool = True         # zero a step whose gradient norm is not
                                    # finite, count it on the device, and
                                    # raise at the next host sync
    jax_debug_nans: bool = False    # JAX only: ignored
    loss_weight: Optional[Tuple[float, float]] = None  # (w_neg, w_pos) BCE weights
    linear_probe: bool = False      # train the head only (the optax chain,
                                    # updates zeroed outside 'head')
    device_resident: Optional[bool] = None  # keep the split on the device and
                                    # gather batches by index; None = when it
                                    # fits hbm_split_max_bytes
    hbm_split_max_bytes: int = 4 << 30
    mesh_data: Optional[int] = None  # ranks on the mesh's 'data' axis (None: the
                                    # ranks left after 'model'); parallel/mesh.py
    mesh_model: int = 1             # ranks on 'model' (Megatron TP, expert parallelism)
    mesh_stage: int = 1             # > 1: GPipe pipeline stages (train/pipeline_vit.py)
    fsdp: bool = False              # ZeRO storage sharding over 'data' (FSDP2)

    def steps_per_epoch(self, n_train: int) -> int:
        # floor: the trainer drops the last partial batch (the reference's
        # ceil(a // b) quirk, train.py:433, is not kept)
        return max(1, n_train // self.train_batch_size)

    def total_steps(self, n_train: int) -> int:
        return self.steps_per_epoch(n_train) * self.num_train_epoch


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Fused preprocessing pipeline settings (reference Zheng chain constants in
    config.json ``pre_processing.zheng``; see ops/ for the kernels)."""
    source_fqs: int = 500
    target_fqs: int = 250
    lowpass_passband: float = 50.0
    lowpass_stopband: float = 60.0
    lowpass_ripple_db: float = 1.0
    lowpass_attenuation_db: float = 2.5
    loess_window: Optional[int] = None   # default: = source fqs (data_preprocessor.py:44)
    # MATLAB 'rloess' runs 5 bisquare robustness iterations; 2 stays within
    # the reference's own export tolerance (atol=10, data_preprocessor.py:196)
    loess_robust_iters: int = 5
    nlm_smooth_factor: float = 1.5
    nlm_patch_halfwidth: int = 10
    nlm_search_width: Optional[int] = None  # None = full signal (data_preprocessor.py:98-99)
