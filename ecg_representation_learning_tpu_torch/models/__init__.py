"""Model layer of the port: the 1-D ViT (with Switch-MoE blocks,
``models.moe``), the MAE and contrastive pretraining models, the flax <->
torch weight mapping with the reference's vit-pytorch checkpoints,
weight-only int8 (``models.quantize``), the serving artifact
(``models.export_artifact``) and the signal tokenizer
(``models.tokenizer``)."""
from .contrastive import EcgContrastive, nt_xent
from .export_artifact import ExportedModel, export_model
from .mae import EcgMae, MaeOutput, patchify, random_masking, unpatchify
from .moe import MoeMlp
from .port import (export_vit_pytorch_state_dict, flax_params_from_state_dict,
                   fused_adamw_state_from_flax, load_reference_checkpoint,
                   port_vit_pytorch_state_dict, reference_vit_config, state_dict_from_flax,
                   strip_wrapper_prefix, vit_state_dict_from_flax)
from .tokenizer import EcgTokenizer
from .vit import (EcgVit, EcgVitEncoder, VitOutput, bce_with_logits, create_vit,
                  forward_flops_per_sample, param_count, stack_unrolled_state_dict,
                  train_step_flops_per_sample, unstack_scanned_state_dict)

__all__ = ['EcgContrastive', 'EcgMae', 'EcgTokenizer', 'EcgVit', 'EcgVitEncoder',
           'ExportedModel', 'MaeOutput',
           'VitOutput', 'bce_with_logits', 'create_vit', 'export_vit_pytorch_state_dict',
           'flax_params_from_state_dict', 'forward_flops_per_sample',
           'fused_adamw_state_from_flax', 'load_reference_checkpoint', 'MoeMlp', 'nt_xent',
           'param_count', 'patchify', 'port_vit_pytorch_state_dict', 'random_masking',
           'reference_vit_config', 'stack_unrolled_state_dict', 'state_dict_from_flax',
           'strip_wrapper_prefix', 'train_step_flops_per_sample', 'unpatchify',
           'unstack_scanned_state_dict',
           'vit_state_dict_from_flax', 'export_model']
