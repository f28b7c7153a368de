"""Conditioner registry: embedders with ucg-rate dropout and cond/uncond
pair generation (counterpart of star_tpu/models/conditioner.py).

Each embedder reads one batch key, tokenises and encodes its texts, and
lands under an output key chosen by the rank of what it returns
(2 vector, 3 crossattn, 5 concat); the CFG pair re-encodes with the
unconditional input (empty text) or a negative batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

OUTPUT_KEY_BY_RANK = {2: 'vector', 3: 'crossattn', 5: 'concat'}


@dataclasses.dataclass
class TextEmbedder:
    """Tokenise and encode texts into a conditioning tensor; `encode` takes
    the token ids as a torch tensor on the host, moves them to its model's
    device and returns the embedding."""
    input_key: str
    tokenizer: Any
    encode: Callable[[torch.Tensor], torch.Tensor]
    ucg_rate: float = 0.0

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        return self.encode(torch.as_tensor(self.tokenizer(list(texts))))


class GeneralConditioner:
    def __init__(self, embedders: Sequence[TextEmbedder], seed: int = 0):
        self.embedders = list(embedders)
        self._rng = np.random.RandomState(seed)

    def __call__(self, batch: Dict[str, Any],
                 force_uncond: bool = False) -> Dict[str, torch.Tensor]:
        """batch -> {output key: embedding}; training-time ucg dropout
        blanks each sample's text with probability ucg_rate."""
        out: Dict[str, torch.Tensor] = {}
        for emb in self.embedders:
            texts = list(batch[emb.input_key])
            if force_uncond:
                texts = [''] * len(texts)
            elif emb.ucg_rate > 0:
                texts = ['' if self._rng.rand() < emb.ucg_rate else t
                         for t in texts]
            enc = emb(texts)
            key = OUTPUT_KEY_BY_RANK.get(enc.ndim, 'crossattn')
            out[key] = (torch.cat([out[key], enc], dim=-1) if key in out
                        else enc)
        return out

    def get_unconditional_conditioning(
            self, batch: Dict[str, Any],
            negative_batch: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(cond, uncond) for CFG; uncond from the negative batch when
        given, from empty texts otherwise."""
        c = self(batch)
        uc = self(negative_batch if negative_batch is not None else batch,
                  force_uncond=negative_batch is None)
        return c, uc
