"""Process-aware logger (counterpart of star_tpu/utils/logger.py;
reference: video_to_video/utils/logger.py).

The rank is torch.distributed's when a process group is initialised, and 0
otherwise. Processes of a rank other than 0 log at WARNING, to keep
multi-process output readable.
"""

from __future__ import annotations

import logging
import sys

import torch.distributed as dist

_FORMAT = '%(asctime)s - %(name)s - %(levelname)s - %(message)s'
_initialized = set()


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_logger(name: str = 'star_tpu_torch') -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _initialized:
        return logger
    _initialized.add(name)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    logger.setLevel(logging.INFO if _rank() == 0 else logging.WARNING)
    return logger
