"""Model layer of the port: the 1-D ViT and the flax <-> torch weight mapping."""
from .port import (flax_params_from_vit_state_dict, fused_adamw_state_from_flax,
                   vit_state_dict_from_flax)
from .vit import EcgVit, EcgVitEncoder, VitOutput, bce_with_logits, forward_flops_per_sample

__all__ = ['EcgVit', 'EcgVitEncoder', 'VitOutput', 'bce_with_logits',
           'forward_flops_per_sample', 'flax_params_from_vit_state_dict',
           'fused_adamw_state_from_flax',
           'vit_state_dict_from_flax']
