"""T5 tokenizer on the host, gated on its asset
(counterpart of star_tpu/models/t5/tokenizer.py).

The reference tokenizes with SentencePiece (padding to max_length 226,
truncation; ids + </s> (1), pad id 0). Without the `spiece.model` asset
and the `sentencepiece` package:

  * T5SentencePieceTokenizer — full fidelity when both are present (pass
    spiece_path or set STAR_TPU_T5_SPIECE);
  * T5HashTokenizer — a deterministic stand-in for tests and random-weight
    runs, NOT vocabulary-compatible with pretrained weights. It hashes
    words with Python's hash(), as the JAX package's does, so both give the
    same ids within one process.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

MAX_LENGTH = 226
PAD_ID = 0
EOS_ID = 1
VOCAB_SIZE = 32128


class T5SentencePieceTokenizer:
    def __init__(self, spiece_path: str):
        import sentencepiece as spm
        if not os.path.exists(spiece_path):
            raise FileNotFoundError(spiece_path)
        self.sp = spm.SentencePieceProcessor(model_file=spiece_path)

    def __call__(self, texts: str | Iterable[str],
                 max_length: int = MAX_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), PAD_ID, np.int32)
        for i, t in enumerate(texts):
            ids = self.sp.encode(t)[:max_length - 1] + [EOS_ID]
            out[i, :len(ids)] = ids
        return out


class T5HashTokenizer:
    """Deterministic pseudo-ids for tests and random-weight runs ONLY."""

    def __call__(self, texts: str | Iterable[str],
                 max_length: int = MAX_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), PAD_ID, np.int32)
        for i, t in enumerate(texts):
            ids = [2 + (hash(w) % (VOCAB_SIZE - 2)) for w in t.lower().split()]
            ids = ids[:max_length - 1] + [EOS_ID]
            out[i, :len(ids)] = ids
        return out


def default_t5_tokenizer(spiece_path: str | None = None,
                         allow_fallback: bool = False):
    """The SentencePiece tokenizer; RAISES without the asset unless
    allow_fallback=True (tests and random-weight runs: hash ids are not
    compatible with real T5 weights)."""
    candidates = [spiece_path, os.environ.get('STAR_TPU_T5_SPIECE', ''),
                  os.path.join(os.path.dirname(__file__), 'spiece.model')]
    for c in candidates:
        if c and os.path.exists(c):
            try:
                return T5SentencePieceTokenizer(c)
            except ImportError:
                break
    if not allow_fallback:
        raise FileNotFoundError(
            'T5 spiece.model not found (set STAR_TPU_T5_SPIECE or pass '
            'spiece_path). Pass allow_fallback=True only for tests and '
            'random-weight runs.')
    return T5HashTokenizer()
