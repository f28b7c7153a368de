"""Training datasets (counterpart of star_tpu/data/dataset.py; host-side
numpy samples, which the training CLIs move to the device).

Behavioral reference: video_super_resolution/dataset.py
(PairedCaptionVideoDataset: {gt,lq,text} triplet dirs, null_text_ratio
caption dropout, first num_frames frames, [-1,1] normalize) and
cogvideox-based/sat/data_video.py (PairedCaptionDataset:458 with the 720p
resize/crop rules, frames=4k+1).
"""

from __future__ import annotations

import os
import random
from typing import Iterator, List

import numpy as np

from .io import load_video


class PairedCaptionVideoDataset:
    """Iterates {root}/gt/*.mp4 + {root}/lq/*.mp4 + {root}/text/*.txt.

    Yields dicts of gt/lq float32 [-1,1] [F,H,W,3] + text. Mirrors
    dataset.py:11-61 (null_text_ratio=0.5 default caption dropout).
    """

    def __init__(self, root: str, num_frames: int = 32,
                 null_text_ratio: float = 0.5, seed: int = 0,
                 clean_captions: bool = False):
        self.root = root
        self.num_frames = num_frames
        self.null_text_ratio = null_text_ratio
        self.clean_captions = clean_captions
        self.rng = random.Random(seed)
        self._pending: List[int] = []   # the rest of an epoch skip() cut
        lq_dir = os.path.join(root, 'lq')
        self.names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(lq_dir)
            if f.endswith('.mp4'))

    def _caption(self, name: str) -> str:
        if self.rng.random() < self.null_text_ratio:
            return ''
        with open(os.path.join(self.root, 'text', name + '.txt')) as f:
            text = f.read().strip()
        if self.clean_captions:
            from .captions import text_preprocessing
            text = text_preprocessing(text)
        return text

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int) -> dict:
        name = self.names[idx]
        gt, _ = load_video(os.path.join(self.root, 'gt', name + '.mp4'))
        lq, _ = load_video(os.path.join(self.root, 'lq', name + '.mp4'))
        gt = gt[:self.num_frames]
        lq = lq[:self.num_frames]
        text = self._caption(name)
        to11 = lambda x: (x.astype(np.float32) / 255.0 - 0.5) / 0.5
        return {'gt': to11(gt), 'lq': to11(lq), 'text': text}

    def _shuffled(self) -> List[int]:
        order = list(range(len(self)))
        self.rng.shuffle(order)
        return order

    def __iter__(self) -> Iterator[dict]:
        order, self._pending = self._pending or self._shuffled(), []
        for i in order:
            yield self[i]

    def skip(self, n: int) -> None:
        """Move past the next n samples with the draws that iterating
        makes (each epoch's shuffle, each sample's caption draw) but no
        file read, so that a resumed run sees what a continued one sees;
        the next iteration starts with the rest of a part-read epoch."""
        order = self._pending
        while n:
            order = order or self._shuffled()
            k = min(n, len(order))
            for _ in range(k):
                self.rng.random()
            order, n = order[k:], n - k
        self._pending = order


class CogPairedCaptionDataset(PairedCaptionVideoDataset):
    """CogVideoX variant (data_video.py:458-527): videos wider than 720 are
    resized by 2/3 and center-cropped to 480x720; LQ narrower than 720 is
    bicubic-upsampled x4; frames truncated to num_frames (4k+1)."""

    def __init__(self, root: str, num_frames: int = 25,
                 null_text_ratio: float = 0.5, seed: int = 0,
                 clean_captions: bool = False):
        super().__init__(root, num_frames, null_text_ratio, seed,
                         clean_captions)

    @staticmethod
    def _fit(frames: np.ndarray, is_lq: bool) -> np.ndarray:
        import cv2
        f, h, w, _ = frames.shape
        if w > 720:
            nh, nw = int(h * 2 / 3), int(w * 2 / 3)
            frames = np.stack([cv2.resize(fr, (nw, nh),
                                          interpolation=cv2.INTER_LINEAR)
                               for fr in frames])
            top = (nh - 480) // 2
            left = (nw - 720) // 2
            frames = frames[:, top:top + 480, left:left + 720]
        elif is_lq and w < 720:
            frames = np.stack([cv2.resize(fr, (w * 4, h * 4),
                                          interpolation=cv2.INTER_CUBIC)
                               for fr in frames])
        return frames

    def __getitem__(self, idx: int) -> dict:
        name = self.names[idx]
        gt, fps = load_video(os.path.join(self.root, 'gt', name + '.mp4'))
        lq, _ = load_video(os.path.join(self.root, 'lq', name + '.mp4'))
        gt = self._fit(gt, False)[:self.num_frames]
        lq = self._fit(lq, True)[:self.num_frames]
        text = self._caption(name)
        to11 = lambda x: (x.astype(np.float32) / 255.0) * 2.0 - 1.0
        return {'gt': to11(gt), 'lq': to11(lq), 'text': text, 'fps': fps}


class PairedCaptionImageDataset:
    """Single-image pair dataset: {root}/sr_bicubic/*.png + {root}/gt/*.png.

    Mirrors video_super_resolution/dataset.py:63-111: center-crop to
    crop_size (default 720x1280), [-1,1] normalize, empty caption, and the
    image becomes a one-frame video — the reference unsqueezes a frame axis
    so image pairs feed the same video trainer. Yields gt/lq [1,H,W,3]."""

    def __init__(self, root: str, crop_size=(720, 1280)):
        self.root = root
        self.crop_size = crop_size
        self._start = 0
        lq_dir = os.path.join(root, 'sr_bicubic')
        self.names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(lq_dir)
            if f.endswith('.png'))

    def __len__(self):
        return len(self.names)

    def _load(self, sub: str, name: str) -> np.ndarray:
        import cv2
        img = cv2.imread(os.path.join(self.root, sub, name + '.png'),
                         cv2.IMREAD_COLOR)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        ch, cw = self.crop_size
        h, w = img.shape[:2]
        if h < ch or w < cw:  # torchvision CenterCrop zero-pads small images
            ph, pw = max(ch - h, 0), max(cw - w, 0)
            img = np.pad(img, ((ph // 2, ph - ph // 2),
                               (pw // 2, pw - pw // 2), (0, 0)))
            h, w = img.shape[:2]
        top = (h - ch) // 2
        left = (w - cw) // 2
        img = img[top:top + ch, left:left + cw]
        return (img.astype(np.float32) / 255.0) * 2.0 - 1.0

    def __getitem__(self, idx: int) -> dict:
        name = self.names[idx]
        return {'gt': self._load('gt', name)[None],
                'lq': self._load('sr_bicubic', name)[None],
                'text': ''}

    def __iter__(self) -> Iterator[dict]:
        start, self._start = self._start, 0
        for i in range(start, len(self)):
            yield self[i]

    def skip(self, n: int) -> None:
        """Move past the next n samples (the order is fixed) without
        reading them."""
        self._start = (self._start + n) % len(self)


def shard_for_process(items: List, process_index: int,
                      process_count: int) -> List:
    """Rank-strided work split (the reference's prompt-list DP sharding,
    sample_sr.py:38-45)."""
    return items[process_index::process_count]
