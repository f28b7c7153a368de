"""CLIP BPE tokenizer (host-side); the port's own copy of
star_tpu/models/clip/tokenizer.py.

Implements the standard CLIP byte-pair-encoding scheme used by OpenCLIP's
`tokenize` (referenced at embedder.py:50). The merge table ships with
open_clip as bpe_simple_vocab_16e6.txt.gz and is not part of this
repository, so construction is gated on a local copy of that file. A deterministic
hash-based fallback tokenizer is provided for tests/benchmarks — it is NOT
vocabulary-compatible with pretrained weights and says so loudly.

Special ids: <start_of_text> 49406, <end_of_text> 49407; sequences are
EOT-terminated and zero-padded to context_length 77.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Iterable, List

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT_ID = 49406
EOT_ID = 49407


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (standard GPT-2/CLIP BPE)."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('¡'), ord('¬') + 1))
          + list(range(ord('®'), ord('ÿ') + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r'\s+', ' ', text).strip()


class CLIPTokenizer:
    """Full CLIP BPE; requires the merge table file (txt or txt.gz)."""

    def __init__(self, bpe_path: str):
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(
                f'CLIP BPE merge table not found: {bpe_path}. Provide '
                'bpe_simple_vocab_16e6.txt.gz (ships with open_clip).')
        if bpe_path.endswith('.gz'):
            with gzip.open(bpe_path, 'rt', encoding='utf-8') as f:
                merges = f.read().split('\n')
        else:
            with open(bpe_path, encoding='utf-8') as f:
                merges = f.read().split('\n')
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + '</w>' for v in vocab]
        for m in merges:
            vocab.append(''.join(m))
        vocab.extend(['<start_of_text>', '<end_of_text>'])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {'<start_of_text>': '<start_of_text>',
                      '<end_of_text>': '<end_of_text>'}
        # CLIP's original pattern uses \p{L}/\p{N} (regex module); stdlib re
        # lacks those, so letters/digits are matched via str.isalpha-equivalent
        # unicode categories through the ASCII classes + a unicode word class.
        # For English prompts (STAR's domain) this is token-identical.
        self.pat = re.compile(
            r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|"""
            r"""[^\W\d_]+|[0-9]|[^\s\w]+""",
            re.IGNORECASE | re.UNICODE)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = get_pairs(word)
        if not pairs:
            return token + '</w>'
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float('inf')))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = ' '.join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = ''.join(self.byte_encoder[b] for b in token.encode('utf-8'))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(' '))
        return bpe_tokens

    def __call__(self, texts: str | Iterable[str],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [SOT_ID] + self.encode(text) + [EOT_ID]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = EOT_ID
            result[i, :len(ids)] = ids
        return result


class HashTokenizer:
    """Deterministic stand-in tokenizer for tests/benchmarks ONLY.

    Produces stable pseudo-ids by hashing whitespace words into the BPE id
    range. NOT compatible with pretrained CLIP weights — use CLIPTokenizer
    with the real merge table for fidelity work.
    """

    def __call__(self, texts: str | Iterable[str],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            words = whitespace_clean(basic_clean(text)).lower().split(' ')
            ids = [SOT_ID] + [(hash(w) % (VOCAB_SIZE - 2)) for w in words][
                :context_length - 2] + [EOT_ID]
            result[i, :len(ids)] = ids
        return result


def default_tokenizer(bpe_path: str | None = None,
                      allow_fallback: bool = False):
    """CLIPTokenizer if a merge table is available.

    Without the asset this RAISES unless allow_fallback=True (tests /
    random-weight smoke runs): a hash tokenizer silently feeding a fidelity
    run would produce garbage with only a log line, the same failure class
    the random-weights hard gate exists for."""
    candidates = [bpe_path] if bpe_path else []
    candidates += [
        os.environ.get('STAR_TPU_CLIP_BPE', ''),
        os.path.join(os.path.dirname(__file__), 'bpe_simple_vocab_16e6.txt.gz'),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return CLIPTokenizer(c)
    if not allow_fallback:
        raise FileNotFoundError(
            'CLIP BPE merge table not found (set STAR_TPU_CLIP_BPE or pass '
            'bpe_path). Pass allow_fallback=True only for tests/smoke runs '
            '— the hash tokenizer is NOT compatible with real weights.')
    return HashTokenizer()
