"""Inputs made from the seed: captions, their tokens, and clips.

The tokenizer is the benchmark's own, the same for the program and the
reference: start token, one id per whitespace word (its CRC-32 modulo the
vocabulary less the two special ids), end token, zero padding."""

from __future__ import annotations

import zlib

import numpy as np

WORDS = ('a', 'the', 'old', 'red', 'small', 'river', 'street', 'city',
         'night', 'boat', 'dog', 'running', 'across', 'under', 'bright',
         'crowd', 'market', 'forest', 'snow', 'rain', 'car', 'bridge',
         'window', 'light', 'face', 'slowly', 'people', 'walking', 'sea',
         'mountain', 'field', 'bird')


class WordHashTokenizer:
    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 sot: int = 49406, eot: int = 49407):
        self.n, self.vocab, self.sot, self.eot = (context_length, vocab_size,
                                                  sot, eot)

    def ids(self, text: str) -> list[int]:
        words = [zlib.crc32(w.encode()) % (self.vocab - 2)
                 for w in text.lower().split()]
        ids = [self.sot] + words[:self.n - 2] + [self.eot]
        return ids + [0] * (self.n - len(ids))

    def __call__(self, texts) -> np.ndarray:
        texts = [texts] if isinstance(texts, str) else list(texts)
        return np.asarray([self.ids(t) for t in texts], dtype=np.int64)


def captions(seed: int, n: int, words: int = 12) -> list[str]:
    """n captions of `words` words each, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return [' '.join(rng.choice(WORDS, size=words)) for _ in range(n)]


def clip_frames(seed: int, index: int, frames: int, height: int,
                width: int, cell: int = 8) -> np.ndarray:
    """A uint8 clip [F, H, W, 3] drawn from (seed, index): a coarse random
    colour field (one value per `cell` x `cell` pixels) drifting by a
    pixel a frame, bilinearly smoothed, with fine noise on top."""
    rng = np.random.default_rng([seed, 2, index])
    gh, gw = height // cell + 2, width // cell + 2
    base = rng.uniform(20.0, 235.0, size=(gh, gw, 3))
    ys = (np.arange(height) + 0.5) / cell
    xs = (np.arange(width) + 0.5) / cell
    out = np.empty((frames, height, width, 3), np.float64)
    for f in range(frames):
        x = xs + f / cell
        y0, x0 = np.floor(ys).astype(int), np.floor(x).astype(int)
        wy, wx = (ys - y0)[:, None, None], (x - x0)[None, :, None]
        x0 = np.minimum(x0, gw - 2)
        a = base[y0][:, x0]
        b = base[y0][:, x0 + 1]
        c = base[y0 + 1][:, x0]
        d = base[y0 + 1][:, x0 + 1]
        out[f] = ((1 - wy) * ((1 - wx) * a + wx * b)
                  + wy * ((1 - wx) * c + wx * d))
    out += rng.normal(0.0, 6.0, size=out.shape)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class WordHashT5Tokenizer:
    """The T5 form of the word-hash tokenizer: one id per word (2 plus its
    CRC-32 modulo the vocabulary less two), the end token 1, zero
    padding to `length`."""

    def __init__(self, length: int = 226, vocab_size: int = 32128):
        self.n, self.vocab = length, vocab_size

    def __call__(self, texts) -> np.ndarray:
        texts = [texts] if isinstance(texts, str) else list(texts)
        out = np.zeros((len(texts), self.n), np.int64)
        for i, t in enumerate(texts):
            ids = [2 + zlib.crc32(w.encode()) % (self.vocab - 2)
                   for w in t.lower().split()][:self.n - 1] + [1]
            out[i, :len(ids)] = ids
        return out


def video_pairs(seed: int, n: int, frames: int, height: int, width: int,
                device) -> list[dict]:
    """n training triplets {gt, lq: float32 [F, H, W, 3] in [-1, 1] on the
    host, text} drawn on `device` from the seed: gt a coarse random colour
    field drifting a pixel a frame, bilinearly smoothed, with fine noise;
    lq its x4 box-downsampled, bilinearly upsampled copy with noise."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=device).manual_seed(seed)
    texts = captions(seed, n)
    out = []
    for i in range(n):
        base = torch.rand(1, 3, height // 16 + 2, width // 16 + 2,
                          generator=g, device=device) * 1.6 - 0.8
        clip = []
        for f in range(frames):
            shifted = torch.roll(base, shifts=-(f // 4), dims=-1)
            clip.append(F.interpolate(shifted, size=(height + 32,
                                                     width + 32),
                                      mode='bilinear',
                                      align_corners=False)[..., 16:-16,
                                                           16:-16])
        gt = torch.cat(clip)
        gt = gt + 0.05 * torch.randn(gt.shape, generator=g, device=device)
        lq = F.interpolate(F.avg_pool2d(gt, 4), size=(height, width),
                           mode='bilinear', align_corners=False)
        lq = lq + 0.05 * torch.randn(lq.shape, generator=g, device=device)
        to_host = lambda t: t.clamp(-1, 1).permute(0, 2, 3, 1).float() \
            .cpu().numpy()
        out.append({'gt': to_host(gt), 'lq': to_host(lq), 'text': texts[i]})
    return out
