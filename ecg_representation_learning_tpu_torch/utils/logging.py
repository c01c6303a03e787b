"""Console (and optional file) logger, as in the JAX package's utils/logging.py."""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

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
