"""Logging: console + file + TensorBoard sinks, as in the JAX package's utils/logging.py.

Reference: colored console logger / plain file logger / TensorBoard scalars
written in parallel by the trainer (models/train.py:229-239, 380-397).
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Any, Dict, Optional

_FMT = '%(asctime)s | %(name)s | %(levelname)s - %(message)s'
_DATEFMT = '%Y-%m-%d %H:%M:%S'

_LEVEL_COLOR = {
    logging.DEBUG: '\x1b[2m',        # dim
    logging.INFO: '\x1b[32m',        # green
    logging.WARNING: '\x1b[33m',     # yellow
    logging.ERROR: '\x1b[31m',       # red
    logging.CRITICAL: '\x1b[1;31m',  # bold red
}
_RESET = '\x1b[0m'


class AnsiFormatter(logging.Formatter):
    """Colors the levelname by severity; used only on tty console sinks so
    file logs stay plain."""

    def format(self, record):
        color = _LEVEL_COLOR.get(record.levelno, '')
        record = logging.makeLogRecord(record.__dict__)
        record.levelname = f'{color}{record.levelname}{_RESET}'
        return super().format(record)


def get_logger(name: str, file_path: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    """Console logger; pass ``file_path`` for an additional plain file sink."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    have_console = any(isinstance(h, logging.StreamHandler)
                       and not isinstance(h, logging.FileHandler)
                       for h in logger.handlers)
    if not have_console:
        h = logging.StreamHandler()
        fmt_cls = (AnsiFormatter if getattr(sys.stderr, 'isatty', lambda: False)()
                   else logging.Formatter)
        h.setFormatter(fmt_cls(_FMT, _DATEFMT))
        logger.addHandler(h)
    if file_path:
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, 'baseFilename', None) == os.path.abspath(file_path)
                   for h in logger.handlers):
            os.makedirs(os.path.dirname(file_path) or '.', exist_ok=True)
            h = logging.FileHandler(file_path)
            h.setFormatter(logging.Formatter(_FMT, _DATEFMT))
            logger.addHandler(h)
    return logger


class TbWriter:
    """Thin TensorBoard scalar writer (no-op when neither tensorboardX nor
    torch.utils.tensorboard can be imported).

    Filters non-scalar payloads like the reference's tb_ignore_keys
    (train.py:200, 390-397).
    """

    IGNORE_KEYS = ('step', 'epoch', 'per_class_auc')

    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir:
            try:
                try:
                    from tensorboardX import SummaryWriter
                except ImportError:
                    from torch.utils.tensorboard import SummaryWriter
                os.makedirs(log_dir, exist_ok=True)
                self._writer = SummaryWriter(log_dir)
            except Exception:
                self._writer = None

    def log(self, payload: Dict[str, Any], step: int):
        if self._writer is None:
            return
        for k, v in payload.items():
            if any(key in k for key in self.IGNORE_KEYS) or v is None:
                continue
            if isinstance(v, (int, float)):
                self._writer.add_scalar(k, v, global_step=step)

    def close(self):
        if self._writer is not None:
            self._writer.close()


def pretty_single(key: str, val, ref: Optional[Dict] = None):
    """Human formatting per metric kind (reference util/train.py:59-79)."""
    if key in ('step', 'epoch') and ref:
        k = next((kk for kk in ref if key in kk), None)
        if k:
            lim = ref[k]
            return f'{val:>{len(str(lim))}}/{lim}'
        return val
    if 'loss' in key and isinstance(val, (int, float)):
        return f'{round(val, 4):7.4f}'  # round-then-format, reference util/train.py:65
    if any(k in key for k in ('acc', 'recall', 'auc')):
        def one(v):
            return f'{v * 100:6.2f}' if isinstance(v, (int, float)) else '-'
        if isinstance(val, dict):
            return {k: one(v) for k, v in val.items()}
        if isinstance(val, (list, tuple)):
            return [one(v) for v in val]
        return one(val)
    if ('learning_rate' in key or key == 'lr') and isinstance(val, (int, float)):
        return f'{val:.3e}'
    return val


def pretty_log_dict(d: Dict, ref: Optional[Dict] = None) -> Dict:
    return {k: pretty_single(k, v, ref) for k, v in d.items()}
