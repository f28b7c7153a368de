"""Seeding (counterpart of star_tpu/utils/seed.py; reference:
video_to_video/utils/seed.py).

Seeds Python's and numpy's generators, which data loading and degradation
sampling draw from, and torch's global ones, and returns a generator on the
device for the draws that take one explicitly (the JAX package returns its
root key instead).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .device import resolve_device


def setup_seed(seed: int = 666,
               device: str | torch.device = 'cuda') -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
