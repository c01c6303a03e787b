"""Training of the port: the supervised trainer, the MAE and contrastive
pretrainers, the context-parallel long-record pretrainer and the pipeline
trainer, their optimizers, loop, metrics and checkpoints."""
from .contrastive import ContrastiveTrainer, load_any_encoder
from .long_record import EcgMim, RingPretrainer
from .optim import AdamChain, FusedAdamW, make_optimizer, make_schedule
from .pipeline_vit import PipelineVitTrainer
from .pretrain import MaeTrainer
from .trainer import SplitData, Trainer, get_all_setup

__all__ = ['AdamChain', 'ContrastiveTrainer', 'EcgMim', 'FusedAdamW', 'MaeTrainer',
           'PipelineVitTrainer', 'RingPretrainer', 'SplitData', 'Trainer',
           'get_all_setup', 'load_any_encoder', 'make_optimizer', 'make_schedule']
