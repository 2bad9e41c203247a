"""Rank-aware logging.

A copy of ``deepspeed_tpu/utils/logging.py`` for the PyTorch port: the rank
comes from ``torch.distributed`` when a process group is initialised, else
from the ``RANK`` environment variable (0 for a single process).
"""

from __future__ import annotations

import logging
import os
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class LoggerFactory:

    @staticmethod
    def create_logger(name: str = "deepspeed_tpu_torch",
                      level: int = logging.INFO) -> logging.Logger:
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] "
            "[%(name)s:%(lineno)d:%(funcName)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(
    level=log_levels.get(os.environ.get("DS_TPU_LOG_LEVEL", "info").lower(),
                         logging.INFO))


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (``[-1]`` or None = all)."""
    my_rank = _process_index()
    if ranks is None or len(ranks) == 0 or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
