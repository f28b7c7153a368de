"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = 'cuda') -> torch.device:
    """Return `device` as a torch.device; a CUDA device without a card
    raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'star_tpu_torch runs on a CUDA device and none is available; '
            'pass device="cpu" to run the plain PyTorch versions on the CPU')
    return dev
