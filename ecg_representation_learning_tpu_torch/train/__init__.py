"""Training of the port: the supervised trainer, the MAE and contrastive
pretrainers, their optimizers, loop, metrics and checkpoints."""
from .contrastive import ContrastiveTrainer, load_any_encoder
from .optim import AdamChain, FusedAdamW, make_optimizer, make_schedule
from .pretrain import MaeTrainer
from .trainer import SplitData, Trainer

__all__ = ['AdamChain', 'ContrastiveTrainer', 'FusedAdamW', 'MaeTrainer', 'SplitData',
           'Trainer', 'load_any_encoder', 'make_optimizer', 'make_schedule']
