"""Training of the port: the trainer, its optimizer, loop, metrics and checkpoints."""
from .optim import FusedAdamW, make_optimizer, make_schedule
from .trainer import SplitData, Trainer

__all__ = ['FusedAdamW', 'SplitData', 'Trainer', 'make_optimizer', 'make_schedule']
