"""Rank-aware logging: ``logger`` and ``log_dist``.

The rank comes from ``torch.distributed`` when a process group is initialised,
else it is 0.
"""

import logging
import os
import sys
from typing import Iterable, Optional

import torch.distributed as dist

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str, level: int) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        lg.addHandler(handler)
    return lg


logger = _create_logger(
    "DeepSpeedTPUTorch",
    LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), logging.INFO))


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO):
    """Log ``message`` only on the listed ranks (``None`` / ``[-1]`` = all)."""
    my_rank = _rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
