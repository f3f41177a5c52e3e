"""Rotating-file logging (parity with reference logging_config.py:11-42:
logs/<name>.log, 10 MB x 10 backups, INFO, pathname:lineno format).

The port's copy of mec_tpu/utils/logging_config.py::setup_logging, on
the 'mec_tpu_torch' logger (the engine logs under
'mec_tpu_torch.serving'). The JAX module's silence_xla_aot_warnings
filters an XLA:CPU compile-cache message and has no counterpart here.
"""

from __future__ import annotations

import logging
import os
from logging.handlers import RotatingFileHandler

from mec_tpu_torch.config import Config

FORMAT = ('%(asctime)s %(levelname)s [%(pathname)s:%(lineno)d] '
          '%(message)s')


def setup_logging(name: str = 'emotion_classifier',
                  log_dir: str | None = None,
                  level: int = logging.INFO) -> logging.Logger:
    log_dir = log_dir or Config.LOG_DIR
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger('mec_tpu_torch')
    logger.setLevel(level)
    path = os.path.join(log_dir, f'{name}.log')
    if not any(isinstance(h, RotatingFileHandler)
               and getattr(h, 'baseFilename', '') == os.path.abspath(path)
               for h in logger.handlers):
        handler = RotatingFileHandler(path, maxBytes=10 * 1024 * 1024,
                                      backupCount=10)
        handler.setFormatter(logging.Formatter(FORMAT))
        logger.addHandler(handler)
    return logger
