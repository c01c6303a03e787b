"""Trainer of the port (inference half)."""
from .trainer import SplitData, Trainer

__all__ = ['SplitData', 'Trainer']
