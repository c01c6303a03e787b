"""Model layer of the port: the 1-D ViT, the MAE and contrastive
pretraining models, and the flax <-> torch weight mapping."""
from .contrastive import EcgContrastive, nt_xent
from .mae import EcgMae, MaeOutput, patchify, random_masking, unpatchify
from .port import (flax_params_from_state_dict, fused_adamw_state_from_flax,
                   state_dict_from_flax, vit_state_dict_from_flax)
from .vit import EcgVit, EcgVitEncoder, VitOutput, bce_with_logits, forward_flops_per_sample

__all__ = ['EcgContrastive', 'EcgMae', 'EcgVit', 'EcgVitEncoder', 'MaeOutput',
           'VitOutput', 'bce_with_logits', 'flax_params_from_state_dict',
           'forward_flops_per_sample',
           'fused_adamw_state_from_flax', 'nt_xent', 'patchify', 'random_masking',
           'state_dict_from_flax', 'unpatchify', 'vit_state_dict_from_flax']
