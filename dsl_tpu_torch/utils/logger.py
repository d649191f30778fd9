"""Root logger: the port's own copy of ``dsl_tpu/utils/logger.py``."""

from __future__ import annotations

import logging
import os
import os.path as osp


def get_root_logger(log_file: str | None = None,
                    log_level: int = logging.INFO,
                    name: str = "dsl_tpu_torch") -> logging.Logger:
    """The named logger with a stream handler and, where ``log_file`` is
    given, a file handler for it (added once per file)."""
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    logger.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        path = osp.abspath(log_file)
        if not any(getattr(h, "baseFilename", None) == path
                   for h in logger.handlers):
            os.makedirs(osp.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
